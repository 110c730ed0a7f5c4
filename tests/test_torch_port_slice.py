"""The port's flagship slice as a whole, on the CPU.

  * loaders: identical batches to the JAX package's on a synthetic cohort;
  * feature pass -> per-epoch coupling -> one train step -> eval logits,
    against the same composition of JAX functions from converted weights;
  * the port's CLI end to end (depth 10, 16^3, cap 4), with its artifacts
    checked against the JAX package's formats;
  * the package imports no JAX, and ``--device cuda`` without a GPU raises.
"""

import json
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.data.datasets import MultimodalNiftiDataset as JaxDataset
from otfusion_tpu.data.loader import MultimodalLoader as JaxLoader
from otfusion_tpu.data.loader import feed_dtype_for as jax_feed_dtype_for
from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.train.coupling import coupling_pipeline as jax_pipeline
from otfusion_tpu.train.coupling import group_and_pad as jax_group_and_pad
from otfusion_tpu.train.steps import (
    make_feature_extract_step as jax_feature_step,
    make_fusion_eval_step as jax_eval_step,
    make_fusion_train_step as jax_train_step,
)
from otfusion_tpu.train.train_state import create_train_state
from otfusion_tpu.utils.reporting import ResultsWriter as JaxResultsWriter
from otfusion_tpu.utils.reporting import parse_results_file
from otfusion_tpu_torch.cli import train_ot_attn
from otfusion_tpu_torch.data.datasets import MultimodalNiftiDataset
from otfusion_tpu_torch.data.loader import MultimodalLoader, feed_dtype_for
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.ops import sinkhorn_kernel
from otfusion_tpu_torch.train.coupling import coupling_pipeline, group_and_pad
from otfusion_tpu_torch.train.steps import (
    make_feature_extract_step,
    make_fusion_eval_step,
    make_fusion_train_step,
)
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.utils.convert import fusion_state_dict_from_jax

REPO = Path(__file__).resolve().parents[1]
T = torch.from_numpy
SHAPE = (16, 16, 16)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("adni")
    make_synthetic_adni(root, n_per_class=4, shape=(12, 12, 12))
    return root


@pytest.mark.parametrize("bf16", [False, True])
def test_loader_batches_match_jax(cohort, bf16):
    ours = MultimodalNiftiDataset(str(cohort)).samples
    ref = JaxDataset(str(cohort)).samples
    assert ours == ref and len(ours) == 8
    feed = feed_dtype_for(torch.bfloat16 if bf16 else None)
    jfeed = jax_feed_dtype_for(jnp.bfloat16 if bf16 else jnp.float32)
    a = MultimodalLoader(ours, SHAPE, 3, shuffle=True, augment=True, seed=7,
                         feed_dtype=feed)
    b = JaxLoader(ref, SHAPE, 3, shuffle=True, augment=True, seed=7,
                  feed_dtype=jfeed)
    for _ in range(2):  # two epochs: the shuffle and the augmentation keys
        batches = list(zip(a, b, strict=True))
        assert len(batches) == 3
        for (mri, pet, lbl), (jmri, jpet, jlbl) in batches:
            assert mri.dtype == feed
            np.testing.assert_array_equal(mri.float().numpy(),
                                          np.asarray(jmri, np.float32))
            np.testing.assert_array_equal(pet.float().numpy(),
                                          np.asarray(jpet, np.float32))
            np.testing.assert_array_equal(lbl.numpy(), jlbl)


def _inert_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    if isinstance(context.module, nn.MultiHeadDotProductAttention):
        object.__setattr__(context.module, "deterministic", True)
    return next_fun(*args, **kwargs)


def test_slice_matches_jax_composition(cohort):
    """Feature pass -> coupling (cap 4) -> one train step -> eval logits."""
    samples = JaxDataset(str(cohort)).samples
    jax_batches = list(JaxLoader(samples, SHAPE, 4))
    our_batches = list(MultimodalLoader(samples, SHAPE, 4))
    mri0, pet0, _ = jax_batches[0]

    jm = JaxFusion(depth=10, s2d_stem=True)
    tv0 = jnp.full((512, 512), 1.0 / 512**2, jnp.float32)
    # jitted: flax's init op by op takes several times its compile time
    state = jax.jit(lambda key: create_train_state(
        jm, key, (mri0[:1], pet0[:1]), 1e-5, t_feature=tv0))(
            jax.random.key(0))
    tm = MultimodalOTFusion(depth=10, s2d_stem=True, projection_dropout=0.0,
                            attention_dropout=0.0)
    tm.load_state_dict(fusion_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats)))

    # feature pass
    jstep = jax_feature_step(jm, jit=True)
    jfeats = [jstep(state, m, p) for m, p, _ in jax_batches]
    j_mri = np.concatenate([np.asarray(f[0]) for f in jfeats])
    j_pet = np.concatenate([np.asarray(f[1]) for f in jfeats])
    tstep = make_feature_extract_step(tm)
    tfeats = [tstep(m, p) for m, p, _ in our_batches]
    t_mri = torch.cat([f[0] for f in tfeats]).numpy()
    t_pet = torch.cat([f[1] for f in tfeats]).numpy()
    for ours, ref in ((t_mri, j_mri), (t_pet, j_pet)):
        assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()

    # coupling, each side from its own features
    labels = np.concatenate([np.asarray(b[2]) for b in jax_batches])
    jg = [jax_group_and_pad(f, labels, 2, 4) for f in (j_pet, j_mri)]
    tg = [group_and_pad(f, labels, 2, 4) for f in (t_pet, t_mri)]
    tv_j, gw_j, fot_j = jax_pipeline(jg[0][0], jg[1][0], jg[0][1], jg[1][1])
    tv_t, gw_t, fot_t = coupling_pipeline(T(tg[0][0]), T(tg[1][0]),
                                          T(tg[0][1]), T(tg[1][1]))
    tv_j = np.asarray(tv_j)
    assert np.abs(tv_t.numpy() - tv_j).max() <= 1e-4 * tv_j.max()
    np.testing.assert_array_equal(gw_t.n_iters.numpy(),
                                  np.asarray(gw_j.n_iters))
    assert fot_t.n_iters == int(fot_j.n_iters)

    # one train step on the first batch, dropout inert, each with its Tv
    mri, pet, lbl = jax_batches[0]
    # the interceptor acts while the jitted step is traced
    with nn.intercept_methods(_inert_dropout):
        state, jmet = jax_train_step(jm, jit=True, donate=False)(
            state, mri, pet, lbl, jnp.asarray(tv_j), jax.random.key(1))
    tmri, tpet, tlbl = our_batches[0]
    optimizer = make_optimizer(tm.parameters(), 1e-5)
    tmet = make_fusion_train_step(tm, optimizer)(tmri, tpet, tlbl, tv_t)
    for key in ("loss", "ce_loss", "ot_loss"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-5)
    assert int(tmet["correct"]) == int(jmet["correct"])

    # eval logits after the update (new weights and BN statistics)
    jlog = np.asarray(jax_eval_step(jm, jit=True)(
        state, mri, pet, lbl, jnp.asarray(tv_j))["logits"])
    tlog = make_fusion_eval_step(tm)(tmri, tpet, tlbl, tv_t)["logits"].numpy()
    np.testing.assert_allclose(tlog, jlog, rtol=1e-4, atol=1e-4)


def test_cli_end_to_end_on_cpu(cohort, tmp_path):
    out = tmp_path / "run"
    sinkhorn_kernel.COUNTER.reset()
    result = train_ot_attn.main([
        "--device", "cpu", "--epochs", "2", "--model-depth", "10",
        "--target-shape", "16", "16", "16", "--max-jax-samples", "4",
        "--batch-size", "2", "--val-fraction", "0.5", "--data-dir", str(cohort),
        "--save-path", str(out)])
    # CPU tensors never reach a kernel
    assert sinkhorn_kernel.COUNTER.count == 0
    for name in ("results.txt", "metrics.jsonl", "model_config.json",
                 "t_feature.npy", "best_model/checkpoint.pt",
                 "latest/checkpoint.pt", "train_split.json",
                 "val_split.json", "patient_ids_all.json"):
        assert (out / name).exists(), name

    tv = np.load(out / "t_feature.npy")
    assert tv.shape == (512, 512) and np.isfinite(tv).all()
    assert tv.sum() == pytest.approx(1.0, abs=1e-3)

    rows = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert set(rows[0]["phase_seconds"]) == {"train", "eval", "checkpoint",
                                              "coupling"}
    assert set(rows[1]["phase_seconds"]) == {"train", "eval", "checkpoint"}
    for row in rows:
        log = row["coupling_log"]
        assert set(log) == {"gw_outer_iters", "gw_converged", "gw_cost",
                            "fot_converged", "fot_iters"}
        assert len(log["gw_outer_iters"]) == 2 and log["fot_iters"] > 0
        assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])

    config = json.loads((out / "model_config.json").read_text())
    assert config["s2d_stem"] is True and config["dtype"] == "bfloat16"
    assert config["variant"] == "per_epoch_attn"

    # results.txt is the JAX package's format: the JAX writer, fed the
    # same header and rows, writes the same bytes; its parser reads it.
    text = (out / "results.txt").read_text()
    lines = text.splitlines()
    title = lines[0]
    config_lines = {}
    for line in lines[2:lines.index("", 2) - 1]:
        key, value = line.split(": ", 1)
        config_lines[key] = value
    ref_path = tmp_path / "ref_results.txt"
    writer = JaxResultsWriter(ref_path, title, config_lines, style="fusion")
    for row in rows:
        writer.epoch_row(row["epoch"], row["train_loss"], row["train_acc"],
                         row["val_loss"], row["val_acc"], row)
    writer.summary(result["best_val_loss"], result["best_summary"],
                   str(out / "best_model"))
    assert ref_path.read_text() == text
    parsed = parse_results_file(out / "results.txt")
    assert parsed is not None
    assert int(parsed["best_epoch"]) == result["best_summary"]["epoch"]


def test_device_cuda_without_gpu_raises(cohort, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        train_ot_attn.main(["--device", "cuda", "--data-dir", str(cohort),
                            "--save-path", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("flags,error,match", [
    # a 2D family on a volume trainer: refused before any data is read
    (["--mri-backbone", "swin_base_384"], ValueError, "2D images"),
    # UNETR sizes its position embeddings from the volume: a shape its
    # 16^3 patches do not tile is refused when the model is built
    (["--pet-backbone", "unetr_vit", "--target-shape", "20", "20", "20"],
     ValueError, "patch size 16"),
    (["--num-devices", "2"], NotImplementedError, "ROADMAP"),
    (["--multihost"], NotImplementedError, "ROADMAP"),
    (["--tp-size", "2"], NotImplementedError, "ROADMAP"),
])
def test_unported_flags_raise(cohort, tmp_path, flags, error, match):
    with pytest.raises(error, match=match):
        train_ot_attn.main(["--device", "cpu", "--data-dir", str(cohort),
                            "--save-path", str(tmp_path / "run"), *flags])


def test_kernel_wrappers_refuse_non_cpu_non_cuda_tensors():
    meta = torch.empty((4, 3), device="meta")
    vec = torch.empty(3, device="meta")
    row = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_kernel.solve(meta, row, vec, row, 0.1, max_iterations=10)


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import otfusion_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " 'otfusion_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'flax', 'optax') if m in sys.modules]\n"
        "bad += [m for m in sys.modules if m.split('.')[0] == 'otfusion_tpu']\n"
        "assert not bad, bad\n"
        "cli = {'otfusion_tpu_torch.cli.' + n for n in ('train_mri_pet_ot',"
        " 'train_mmfusion', 'train_t1_t2_ot', 'train_unimodal')}\n"
        "assert cli <= set(names), cli - set(names)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
