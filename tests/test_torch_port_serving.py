"""The port's serving entry point (``otfusion_tpu_torch.cli.predict``)
against the JAX package's ``cli/predict.py`` on the CPU.

One tiny JAX flagship run and one tiny JAX unimodal run (depth 10, 8^3,
plain stem, float32) are trained with the JAX loops; each best state
crosses into a port run directory through ``utils.convert`` (the same
``model_config.json`` and ``t_feature.npy``). Both packages' ``predict``
then serve the same cohort under ``--fold-bn``/``--no-fold-bn`` and
``--stem auto``/``as-trained``: the predictions must be identical and
the probabilities within 1e-5.
"""

import csv
import json
import shutil

import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from otfusion_tpu.cli.predict import main as jax_predict
from otfusion_tpu.data.datasets import MultimodalNiftiDataset as JaxMMDataset
from otfusion_tpu.data.datasets import NiftiDataset as JaxNiftiDataset
from otfusion_tpu.train.loop import run_fusion_training as jax_fusion_training
from otfusion_tpu.train.loop import (
    run_unimodal_training as jax_unimodal_training,
)
from otfusion_tpu_torch.cli.predict import main as predict
from otfusion_tpu_torch.data.datasets import (
    CLASS_NAMES_MRI_BINARY,
    CLASS_NAMES_PET_BINARY,
)
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import ResNet3DClassifier
from otfusion_tpu_torch.utils.checkpoint import save_checkpoint
from otfusion_tpu_torch.utils.convert import (
    classifier_state_dict_from_jax,
    fusion_state_dict_from_jax,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_run_dir(jax_dir, port_dir, model, convert):
    """``jax_dir``'s best state as a port run directory."""
    port_dir.mkdir()
    for name in ("model_config.json", "t_feature.npy"):
        if (jax_dir / name).exists():
            shutil.copy(jax_dir / name, port_dir / name)
    raw = ocp.StandardCheckpointer().restore((jax_dir / "best_model")
                                             .resolve())
    model.load_state_dict(convert(raw["params"], raw["batch_stats"]))
    save_checkpoint(port_dir / "best_model", model, block=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{kind: (cohort, JAX run dir, port run dir)}."""
    root = tmp_path_factory.mktemp("serving")
    tree = make_synthetic_adni(root / "adni", n_per_class=3, shape=(8, 8, 8))
    common = dict(model_depth=10, target_shape=(8, 8, 8), batch_size=4,
                  lr=1e-3, epochs=1, seed=0, s2d_stem=False, progress=False)

    ds = JaxMMDataset(root_dir=str(tree),
                      class_names_a=CLASS_NAMES_MRI_BINARY,
                      class_names_b=CLASS_NAMES_PET_BINARY)
    n = len(ds.samples)
    val_idx = list(range(0, n, 3))
    train_idx = [i for i in range(n) if i not in val_idx]
    jax_fusion_training(
        samples=ds.samples, train_idx=train_idx, val_idx=val_idx,
        class_names=CLASS_NAMES_MRI_BINARY,
        class_names_b=CLASS_NAMES_PET_BINARY, variant="per_epoch_attn",
        save_path=str(root / "jax_fusion"), max_jax_samples=4,
        gw_max_iterations=20, sinkhorn_max_iterations=50, **common)
    _port_run_dir(root / "jax_fusion", root / "port_fusion",
                  MultimodalOTFusion(depth=10, s2d_stem=False),
                  fusion_state_dict_from_jax)

    uni = JaxNiftiDataset(root_dir=str(tree),
                          class_names=CLASS_NAMES_MRI_BINARY)
    n = len(uni.samples)
    val_idx = list(range(0, n, 3))
    train_idx = [i for i in range(n) if i not in val_idx]
    jax_unimodal_training(
        samples=uni.samples, train_idx=train_idx, val_idx=val_idx,
        class_names=CLASS_NAMES_MRI_BINARY,
        save_path=str(root / "jax_unimodal"), **common)
    _port_run_dir(root / "jax_unimodal", root / "port_unimodal",
                  ResNet3DClassifier(depth=10, s2d_stem=False),
                  classifier_state_dict_from_jax)
    return {kind: (tree, root / f"jax_{kind}", root / f"port_{kind}")
            for kind in ("fusion", "unimodal")}


def _read(path):
    rows = list(csv.DictReader(open(path)))
    probs = np.asarray([[float(r[k]) for k in r if k.startswith("prob_")]
                        for r in rows])
    return rows, probs


@pytest.mark.parametrize("stem", ["auto", "as-trained"])
@pytest.mark.parametrize("fold", ["--fold-bn", "--no-fold-bn"])
@pytest.mark.parametrize("kind", ["fusion", "unimodal"])
def test_predict_matches_jax(runs, tmp_path, kind, fold, stem):
    tree, jax_dir, port_dir = runs[kind]
    flags = ["--data-dir", str(tree), "--batch-size", "4", "--device", "cpu",
             "--num-workers", "1", fold, "--stem", stem]
    want_path = jax_predict(["--run-dir", str(jax_dir),
                             "--output", str(tmp_path / "jax.csv"), *flags])
    got = predict(["--run-dir", str(port_dir),
                   "--output", str(tmp_path / "port.csv"), *flags])
    want_rows, want_p = _read(want_path)
    got_rows, got_p = _read(got["output"])
    assert len(got_rows) == len(want_rows) == 6 == got["n_samples"]
    assert list(got_rows[0]) == list(want_rows[0])  # the same columns
    path_cols = ("mri_path", "pet_path") if kind == "fusion" else ("path",)
    for g, w in zip(got_rows, want_rows):
        assert [g[c] for c in (*path_cols, "label", "pred")] == \
            [w[c] for c in (*path_cols, "label", "pred")]
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    assert got["samples_per_s"] > 0 and got["median_forward_ms"] > 0


def test_predict_refuses_to_guess_second_modality(tmp_path):
    """A manifest without ``class_names_b`` whose derived PET folders do not
    exist raises (pairing a modality with itself would predict on the wrong
    one); with the table given, empty class folders raise the dataset's
    own error."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "model_config.json").write_text(json.dumps({
        "kind": "fusion", "variant": "mmfusion", "model_depth": 10,
        "target_shape": [8, 8, 8], "num_classes": 2,
        "class_names": {"AD_T1_FIN": 0, "CN_T1_FIN": 1},
    }))
    data = tmp_path / "data"
    (data / "AD_T1_FIN").mkdir(parents=True)
    (data / "CN_T1_FIN").mkdir()
    with pytest.raises(FileNotFoundError, match="class_names_b"):
        predict(["--run-dir", str(run_dir), "--data-dir", str(data),
                 "--device", "cpu"])

    cfg = json.loads((run_dir / "model_config.json").read_text())
    cfg["class_names_b"] = {"AD_T2_FIN": 0, "CN_T2_FIN": 1}
    (run_dir / "model_config.json").write_text(json.dumps(cfg))
    (data / "AD_T2_FIN").mkdir()
    (data / "CN_T2_FIN").mkdir()
    with pytest.raises(RuntimeError, match="No paired samples"):
        predict(["--run-dir", str(run_dir), "--data-dir", str(data),
                 "--device", "cpu"])


def test_predict_device_cuda_without_gpu_raises(runs, monkeypatch):
    tree, _, port_dir = runs["unimodal"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        predict(["--run-dir", str(port_dir), "--data-dir", str(tree)])
