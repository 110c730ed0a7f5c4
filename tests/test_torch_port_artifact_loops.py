"""The port's flagship (``per_epoch_attn``) and unimodal runs at depth 10,
16^3 on the CPU write the JAX loops' ``confusion_matrix.png`` and
``tsne_best_val.png`` at the JAX figures' pixel sizes (the figures
themselves are held to JAX's in tests/test_torch_port_artifacts.py)."""

import importlib
import shutil

import pytest
import torch

from otfusion_tpu_torch.data.png_io import read_png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from otfusion_tpu_torch.data.synthetic import make_synthetic_adni

    root = tmp_path_factory.mktemp("adni")
    make_synthetic_adni(root, n_per_class=4, shape=(12, 12, 12))
    return root


# The files the JAX loops write after the best model's evaluation
# (otfusion_tpu/train/loop.py, run_fusion_training and
# run_unimodal_training), at the JAX functions' pixel sizes (H, W).
JAX_ARTIFACTS = {"confusion_matrix.png": (800, 1000),
                 "tsne_best_val.png": (600, 800)}


@pytest.mark.parametrize("trainer", ["train_ot_attn", "train_unimodal"])
def test_loops_write_both_pngs(cohort, tmp_path, trainer):
    module = importlib.import_module(f"otfusion_tpu_torch.cli.{trainer}")
    out = tmp_path / "run"
    extra = ["--classes", "AD", "CN"] if trainer == "train_unimodal" else []
    result = module.main([
        "--device", "cpu", "--epochs", "1", "--model-depth", "10",
        "--target-shape", "16", "16", "16", "--batch-size", "2",
        "--val-fraction", "0.5", *extra, "--data-dir", str(cohort),
        "--save-path", str(out)])
    try:
        assert len(result["final_targets"]) == 4
        for name, shape in JAX_ARTIFACTS.items():
            image = read_png(out / name)
            assert image.shape == shape + (3,), name
            assert image.min() < 50 and image.max() == 255
    finally:
        shutil.rmtree(out, ignore_errors=True)
