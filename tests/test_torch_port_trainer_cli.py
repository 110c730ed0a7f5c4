"""The port's four new trainer CLIs end to end on the CPU (depth 10,
16^3), against the JAX package's writer and loader.

  * ``train_mri_pet_ot`` (base, with and without ``--grad-accum``),
    ``train_mmfusion``, ``train_t1_t2_ot`` (a cohort in the T1/T2 class
    folders) and ``train_unimodal --classes AD CN``: artifacts, and
    ``results.txt`` byte for byte as the JAX writer writes it from the same
    rows; no kernel launched on the CPU;
  * the unimodal ``Loader`` yields the JAX ``Loader``'s batches;
  * ``filter_classes`` as the JAX CLI's.

The step-level parity of these trainers is in
tests/test_torch_port_trainers.py.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.data.datasets import NiftiDataset as JaxNiftiDataset
from otfusion_tpu.data.loader import Loader as JaxLoader
from otfusion_tpu.data.loader import feed_dtype_for as jax_feed_dtype_for
from otfusion_tpu.utils.reporting import ResultsWriter as JaxResultsWriter
from otfusion_tpu.utils.reporting import parse_results_file
from otfusion_tpu_torch.cli import (
    train_mmfusion,
    train_mri_pet_ot,
    train_t1_t2_ot,
    train_unimodal,
)
from otfusion_tpu_torch.data.datasets import (
    CLASS_NAMES_MRI_BINARY,
    NiftiDataset,
)
from otfusion_tpu_torch.data.loader import Loader, feed_dtype_for
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.ops import gw_kernel, sinkhorn_kernel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: a depth-10 trainer on 16^3 volumes is many
    small CPU ops, and the suite runs several test processes on the
    machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("adni")
    make_synthetic_adni(root, n_per_class=4, shape=(12, 12, 12))
    return root


@pytest.fixture(scope="module")
def t1_t2_cohort(tmp_path_factory, cohort):
    """The same volumes in the T1/T2 trainer's class folders."""
    root = tmp_path_factory.mktemp("adni_t1_t2")
    for cls, size in (("AD", 130), ("CN", 229)):
        for mod, seq in (("MRI", "T1"), ("PET", "T2")):
            shutil.copytree(cohort / f"{cls}_{mod}_{size}_FIN",
                            root / f"1204_{cls}_MRI_{seq}_FIN")
    return root


@pytest.mark.parametrize("bf16", [False, True])
def test_unimodal_loader_batches_match_jax(cohort, bf16):
    """Same cohort index, batch order, flips and feed dtype as the JAX
    ``Loader`` over two epochs (the shuffle and augmentation keys)."""
    ours = NiftiDataset(str(cohort), CLASS_NAMES_MRI_BINARY).samples
    ref = JaxNiftiDataset(str(cohort), CLASS_NAMES_MRI_BINARY).samples
    assert ours == ref and len(ours) == 8
    feed = feed_dtype_for(torch.bfloat16 if bf16 else None)
    a = Loader(ours, (16, 16, 16), 3, shuffle=True, augment=True, seed=7,
               feed_dtype=feed)
    b = JaxLoader(ref, (16, 16, 16), 3, shuffle=True, augment=True, seed=7,
                  feed_dtype=jax_feed_dtype_for(jnp.bfloat16 if bf16
                                                else jnp.float32))
    for _ in range(2):
        batches = list(zip(a, b, strict=True))
        assert len(batches) == len(a) == 3
        for (vol, lbl), (jvol, jlbl) in batches:
            assert vol.dtype == feed and lbl.dtype == torch.int64
            np.testing.assert_array_equal(vol.float().numpy(),
                                          np.asarray(jvol, np.float32))
            np.testing.assert_array_equal(lbl.numpy(), jlbl)


@pytest.fixture
def run_dir(tmp_path):
    """A CLI run's save path, removed after the test: each run's best and
    latest checkpoints of depth-10 networks take hundreds of MB."""
    out = tmp_path / "run"
    yield out
    shutil.rmtree(out, ignore_errors=True)


_CLI_FLAGS = ["--device", "cpu", "--epochs", "2", "--model-depth", "10",
              "--target-shape", "16", "16", "16", "--batch-size", "2",
              "--val-fraction", "0.5"]


def _check_run(out, result, style, n_epochs=2):
    """Artifacts and ``results.txt`` byte for byte as the JAX writer writes
    it from the same header and rows; returns the metrics rows."""
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == list(range(1, n_epochs + 1))
    for row in rows:
        assert set(row["phase_seconds"]) == {"train", "eval", "checkpoint"}
        assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
        assert row["median_step_ms"] > 0
    for name in ("results.txt", "model_config.json",
                 "best_model/checkpoint.pt", "latest/checkpoint.pt"):
        assert (out / name).exists(), name
    text = (out / "results.txt").read_text()
    lines = text.splitlines()
    config_lines = dict(line.split(": ", 1)
                        for line in lines[2:lines.index("", 2) - 1])
    ref_path = out.parent / f"{out.name}_ref_results.txt"
    writer = JaxResultsWriter(ref_path, lines[0], config_lines, style=style)
    for row in rows:
        writer.epoch_row(row["epoch"], row["train_loss"], row["train_acc"],
                         row["val_loss"], row["val_acc"], row)
    writer.summary(result["best_val_loss"], result["best_summary"],
                   str(out / "best_model"))
    assert ref_path.read_text() == text
    parsed = parse_results_file(out / "results.txt")
    assert int(parsed["best_epoch"]) == result["best_summary"]["epoch"]
    return rows


@pytest.mark.parametrize("trainer,variant,flags", [
    (train_mri_pet_ot, "base", ["--epochs", "1"]),
    (train_mri_pet_ot, "base", ["--epochs", "1", "--grad-accum", "2",
                                "--batch-size", "4"]),
    (train_mmfusion, "mmfusion", ["--grad-accum", "2"]),
])
def test_fusion_cli_end_to_end_on_cpu(cohort, run_dir, trainer, variant,
                                      flags):
    """Every in-step solve of the base runs is a 512 x 512 plain solve on
    the CPU (~3 s), so they train one epoch (two solves)."""
    out = run_dir
    sinkhorn_kernel.COUNTER.reset()
    gw_kernel.COUNTER.reset()
    result = trainer.main([*_CLI_FLAGS, "--data-dir", str(cohort),
                           "--save-path", str(out), *flags])
    assert sinkhorn_kernel.COUNTER.count == 0 and gw_kernel.COUNTER.count == 0
    rows = _check_run(out, result, "fusion",
                      1 if "--epochs" in flags else 2)
    assert all(row["coupling_log"] is None for row in rows)
    assert not (out / "t_feature.npy").exists()
    for name in ("train_split.json", "val_split.json",
                 "patient_ids_all.json"):
        assert (out / name).exists(), name
    config = json.loads((out / "model_config.json").read_text())
    assert config["variant"] == variant and config["kind"] == "fusion"


def test_t1_t2_cli_end_to_end_on_cpu(t1_t2_cohort, run_dir):
    out = run_dir
    sinkhorn_kernel.COUNTER.reset()
    gw_kernel.COUNTER.reset()
    result = train_t1_t2_ot.main([
        *_CLI_FLAGS, "--max-jax-samples", "4", "--data-dir",
        str(t1_t2_cohort), "--save-path", str(out)])
    assert sinkhorn_kernel.COUNTER.count == 0 and gw_kernel.COUNTER.count == 0
    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["coupling_log"]["fot_iters"] > 0
    tv = np.load(out / "t_feature.npy")
    assert tv.shape == (512, 512) and tv.sum() == pytest.approx(1.0, abs=1e-3)
    config = json.loads((out / "model_config.json").read_text())
    assert config["class_names"] == train_t1_t2_ot.CLASS_NAMES_T1
    assert config["class_names_b"] == train_t1_t2_ot.CLASS_NAMES_T2
    assert result["best_summary"] is not None
    entry = json.loads((out / "train_split.json").read_text())[0]
    assert "_MRI_T1_FIN" in entry["mri_path"]
    assert "_MRI_T2_FIN" in entry["pet_path"]


def test_unimodal_cli_end_to_end_on_cpu(cohort, run_dir):
    out = run_dir
    sinkhorn_kernel.COUNTER.reset()
    result = train_unimodal.main([
        *_CLI_FLAGS, "--classes", "AD", "CN", "--grad-accum", "2",
        "--data-dir", str(cohort), "--save-path", str(out)])
    assert sinkhorn_kernel.COUNTER.count == 0
    _check_run(out, result, "unimodal")
    config = json.loads((out / "model_config.json").read_text())
    assert config["kind"] == "unimodal"
    assert config["class_names"] == {"AD_MRI_130_FIN": 0,
                                     "CN_MRI_229_FIN": 1}
    ids = json.loads((out / "patient_ids.json").read_text())
    assert set(ids) == {"AD_MRI_130_FIN", "CN_MRI_229_FIN"}
    assert sum(len(v) for v in ids.values()) == 8
    assert result["final_features"].shape == (4, 512)
    assert len(result["final_preds"]) == 4


def test_filter_classes_matches_jax():
    from otfusion_tpu.cli.train_unimodal import filter_classes as jax_filter

    from otfusion_tpu_torch.data.datasets import CLASS_NAMES_MRI_T1

    for wanted in (["AD", "CN"], ["CN", "MCI"], ["MCI"]):
        assert train_unimodal.filter_classes(CLASS_NAMES_MRI_T1, wanted) == \
            jax_filter(CLASS_NAMES_MRI_T1, wanted)
    with pytest.raises(ValueError, match="not found"):
        train_unimodal.filter_classes(CLASS_NAMES_MRI_T1, ["XX"])
