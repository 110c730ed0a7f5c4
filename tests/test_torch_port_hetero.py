"""Heterogeneous OT fusion in the port (BASELINE.json config 5), on the CPU.

  * the fusion model with ``medicalnet-10`` (MRI, 1024 wide at 16^3: the
    "hw" pool keeps 2 depth slices) and ``resnet3d-10`` (PET, 512): the
    forward against JAX in float32, and one train step against JAX in
    float64, as ``test_torch_port_models.py`` holds the default model;
  * the Swin remat step: drop-path masks under remat are drawn again as the
    forward drew them, so its gradients equal the plain step's;
  * ``raw_plan`` with unequal widths raises, as in JAX;
  * the flagship CLI with those backbones, then ``cli/predict.py`` on its
    run with BatchNorm folded and unfolded.

Weights cross from the JAX trees through ``otfusion_tpu_torch.utils.convert``;
inputs come from numpy with a seed. Tolerances are stated at each check.
"""

import functools
import json
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.train.losses import cosine_alignment_loss as jax_cosine
from otfusion_tpu.train.losses import cross_entropy as jax_ce
from otfusion_tpu_torch.cli import predict, train_ot_attn
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.swin import SwinTransformer2D
from otfusion_tpu_torch.train.steps import make_fusion_train_step
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.utils.convert import fusion_state_dict_from_jax
from test_torch_port_models import _inert_dropout, _np_tree, _randomize_bn

T = torch.from_numpy
SPECS = dict(mri_backbone="medicalnet-10", pet_backbone="resnet3d-10")
D_MRI, D_PET = 1024, 512


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hetero_pair(rng):
    mri = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    pet = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    tv = rng.uniform(size=(D_PET, D_MRI)).astype(np.float32)
    tv /= tv.sum()
    jm = JaxFusion(depth=10, **SPECS)
    # The tree's shapes without running (or compiling) flax's init; random
    # leaves at a fan-in scale stand in for its initialisers.
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.key(1), mri, pet, t_feature=tv)

    def leaf(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        if name in ("bias", "mean"):
            return np.zeros(s.shape, np.float32)
        fan_in = int(np.prod(s.shape[:-1])) or 1
        return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    params, stats = variables["params"], variables["batch_stats"]
    for side in ("mri_backbone", "pet_backbone"):
        _randomize_bn(params[side], stats[side], rng)
    tm = MultimodalOTFusion(depth=10, projection_dropout=0.0,
                            attention_dropout=0.0, mri_shape=(16, 16, 16),
                            pet_shape=(16, 16, 16), **SPECS)
    tm.load_state_dict(fusion_state_dict_from_jax(params, stats, **SPECS))
    return (mri, pet, tv), jm, params, stats, tm


def test_hetero_forward_and_train_step_match_jax(rng):
    """The eval forward in float32 (every output within 1e-4 relative and
    absolute), then one update from the same weights with dropout inert on
    both sides, both in float64: the losses within 1e-6 relative (the JAX
    backbones round their features to float32), every gradient leaf
    within rtol 1e-3, atol 1e-6, the new BatchNorm statistics within 1e-7
    (JAX keeps them in float32)."""
    (mri, pet, tv), jm, params, stats, tm = _hetero_pair(rng)
    ref = jax.jit(functools.partial(jm.apply, train=False))(
        {"params": params, "batch_stats": stats}, mri, pet, t_feature=tv)
    out = tm.eval()(T(mri), T(pet), T(tv))
    assert out["mri_feat"].shape == (2, D_MRI)
    assert out["pet_feat"].shape == (2, D_PET)
    assert out["ot_mri_from_pet"].shape == (2, D_MRI)
    for key in ref:
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=1e-4,
                                   atol=1e-4, err_msg=key)

    labels = np.array([0, 1])
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        jm64 = jm.clone(dtype=jnp.float64)

        def loss_fn(p):
            o, mutated = jm64.apply(
                {"params": p, "batch_stats": f64(stats)}, f64(mri), f64(pet),
                t_feature=f64(tv), train=True,
                rngs={"dropout": jax.random.key(3)}, mutable=["batch_stats"])
            ce = jax_ce(o["logits"], labels)
            ot = jax_cosine(o["mri_fused"], o["ot_mri_from_pet"])
            return ce + ot, (ce, ot, mutated["batch_stats"])

        with nn.intercept_methods(_inert_dropout):
            (loss, (ce, ot, new_stats)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(f64(params))
        grads, new_stats = _np_tree(grads), _np_tree(new_stats)

    tm64 = tm.double()
    met = make_fusion_train_step(tm64, make_optimizer(tm64.parameters(),
                                                      1e-5))(
        T(mri).double(), T(pet).double(), T(labels), T(tv).double())
    for name, want in (("loss", loss), ("ce_loss", ce), ("ot_loss", ot)):
        assert float(met[name]) == pytest.approx(float(want), rel=1e-6), name

    want = fusion_state_dict_from_jax(grads, new_stats, **SPECS)
    n_params = 0
    for name, p in tm64.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].double().numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
        n_params += 1
    assert n_params == len([k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))])
    got = tm64.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=1e-7, err_msg=key)


def test_raw_plan_with_unequal_widths_raises(rng):
    """``pet_feat @ Tv.T`` only type-checks when d_pet == d_mri; the port
    gives it no new behaviour."""
    tm = MultimodalOTFusion(depth=10, raw_plan=True, mri_shape=(16, 16, 16),
                            pet_shape=(16, 16, 16), **SPECS).eval()
    x = T(rng.normal(size=(1, 16, 16, 16, 1)).astype(np.float32))
    with pytest.raises(RuntimeError):
        tm(x, x, torch.full((D_PET, D_MRI), 1.0 / (D_PET * D_MRI)))


def test_swin_remat_step_redraws_drop_path_masks(rng):
    """Swin with drop-path 0.5, remat off then on, same weights, input and
    generator seed: the gradients agree to float32 rounding (assert_close's
    float32 default, rtol 1.3e-6, atol 1e-5); a different seed moves the
    loss, so the masks are live."""
    kw = dict(img_size=(32, 32), embed_dim=16, depths=(2, 2), heads=(2, 4),
              window=4, drop_path_rate=0.5)
    torch.manual_seed(0)
    init = SwinTransformer2D(remat=False, **kw).state_dict()
    x = T(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    w = T(rng.normal(size=32).astype(np.float32))

    def step(remat, seed):
        model = SwinTransformer2D(remat=remat, **kw)
        model.load_state_dict(init)
        gen = torch.Generator().manual_seed(seed)
        loss = (model.train()(x, gen)[1] @ w).sum()
        loss.backward()
        return float(loss.detach()), {n: p.grad
                                      for n, p in model.named_parameters()}

    loss, grads = step(False, 1)
    remat_loss, remat_grads = step(True, 1)
    assert remat_loss == loss
    for name, g in grads.items():
        torch.testing.assert_close(remat_grads[name], g, msg=name)
    assert step(False, 2)[0] != loss


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("adni")
    make_synthetic_adni(root, n_per_class=4, shape=(12, 12, 12))
    return root


def test_hetero_flagship_cli_and_serving(cohort, tmp_path, capsys):
    """``train_ot_attn`` with MedicalNet-10 (MRI) and ResNet3D-10 (PET) for
    one epoch: a (512, 1024) plan of mass 1 (within 1e-5); then
    ``cli/predict.py`` on the run, BatchNorm folded (both backbones) and
    unfolded: the same predictions, probabilities within 1e-4 (float32);
    ``--stem auto`` leaves the registry backbones' stems alone."""
    out = tmp_path / "run"
    try:
        result = train_ot_attn.main([
            "--device", "cpu", "--data-dir", str(cohort), "--save-path",
            str(out), "--mri-backbone", "medicalnet-10", "--pet-backbone",
            "resnet3d-10", "--model-depth", "10", "--target-shape", "16",
            "16", "16", "--epochs", "1", "--batch-size", "2",
            "--val-fraction", "0.5", "--dtype", "float32"])
        assert np.isfinite(result["best_val_loss"])
        tv = np.load(out / "t_feature.npy")
        assert tv.shape == (D_PET, D_MRI)
        assert abs(float(tv.sum()) - 1.0) <= 1e-5
        cfg = json.loads((out / "model_config.json").read_text())
        assert (cfg["mri_backbone"], cfg["pet_backbone"]) == (
            "medicalnet-10", "resnet3d-10")
        served = {}
        for flag in ("--fold-bn", "--no-fold-bn"):
            csv = tmp_path / f"{flag}.csv"
            capsys.readouterr()
            res = predict.main(["--device", "cpu", "--run-dir", str(out),
                                "--data-dir", str(cohort), "--output",
                                str(csv), flag])
            log = capsys.readouterr().out
            assert ("BatchNorm folded" in log) == (flag == "--fold-bn")
            # --stem auto rewrites no registry backbone's stem
            assert "space-to-depth" not in log
            assert res["n_samples"] == 8
            rows = csv.read_text().splitlines()[1:]
            served[flag] = (
                [r.split(",")[3] for r in rows],
                np.array([[float(v) for v in r.split(",")[4:]]
                          for r in rows]))
        assert served["--fold-bn"][0] == served["--no-fold-bn"][0]
        assert np.abs(served["--fold-bn"][1]
                      - served["--no-fold-bn"][1]).max() <= 1e-4
    finally:
        shutil.rmtree(out, ignore_errors=True)
