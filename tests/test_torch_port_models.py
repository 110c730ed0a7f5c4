"""The port's models, losses and optimiser against the JAX package, on CPU.

Weights cross from the JAX trees through
``otfusion_tpu_torch.utils.convert``; inputs come from numpy with a seed.
Both sides run in fp32 unless a test says otherwise. BatchNorm scales, biases and running statistics are
randomised first, so eval mode exercises them.
"""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.models.resnet3d import ResNet3DBackbone as JaxBackbone
from otfusion_tpu.train.losses import cosine_alignment_loss as jax_cosine
from otfusion_tpu.train.losses import cross_entropy as jax_ce
from otfusion_tpu.train.train_state import ReduceLROnPlateau as JaxPlateau
from otfusion_tpu.utils.torch_import import resnet3d_tree_from_torch
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import (
    ResNet3DBackbone,
    s2d_stem_kernel,
    space_to_depth_hw,
)
from otfusion_tpu_torch.train.losses import cosine_alignment_loss, cross_entropy
from otfusion_tpu_torch.train.steps import (
    make_fusion_eval_step,
    make_fusion_train_step,
)
from otfusion_tpu_torch.train.train_state import (
    ReduceLROnPlateau,
    make_optimizer,
    set_learning_rate,
)
from otfusion_tpu_torch.utils.convert import (
    fusion_state_dict_from_jax,
    resnet3d_state_dict_from_jax,
)

T = torch.from_numpy


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(params, stats, rng):
    """Random BN scale/bias and running statistics, in place (numpy)."""
    def walk(p, s):
        for key, sub in p.items():
            if key.startswith("BatchNorm"):
                c = sub["scale"].shape
                sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                s[key]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                s[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(sub, dict) and key in s:
                walk(sub, s[key])
    walk(params, stats)


def _backbone(depth, s2d, rng, shape=(2, 16, 16, 16, 1)):
    x = rng.normal(size=shape).astype(np.float32)
    jm = JaxBackbone(depth, s2d_stem=s2d)
    variables = _np_tree(jm.init(jax.random.key(depth), x, train=False))
    params, stats = variables["params"], variables["batch_stats"]
    _randomize_bn(params, stats, rng)
    tm = ResNet3DBackbone(depth, s2d_stem=s2d)
    tm.load_state_dict(resnet3d_state_dict_from_jax(params, stats))
    return x, jm, params, stats, tm


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("depth", [10, 50])
def test_resnet3d_eval_features_match_jax(rng, depth, s2d):
    x, jm, params, stats, tm = _backbone(depth, s2d, rng)
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x,
                              train=False))
    out = tm.eval()(T(x)).detach().numpy()
    assert out.shape == ref.shape == (2, 512 * (1 if depth == 10 else 4))
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_resnet3d_odd_sizes_pad_like_flax_same(rng):
    """Odd spatial sizes make stride-2 SAME padding symmetric (1, 1)."""
    x, jm, params, stats, tm = _backbone(10, False, rng,
                                         shape=(1, 9, 14, 10, 1))
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x,
                              train=False))
    out = tm.eval()(T(x)).detach().numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("depth,s2d", [(10, False), (50, True)])
def test_resnet3d_weights_round_trip_through_torch_import(rng, depth, s2d):
    """JAX tree -> port state_dict -> the JAX package's torch importer
    -> the original JAX tree, leaf for leaf."""
    _, _, params, stats, tm = _backbone(depth, s2d, rng)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    p2, s2 = resnet3d_tree_from_torch(sd, depth, s2d_stem=s2d)
    flat = jax.tree_util.tree_leaves_with_path
    ref_p, ref_s = dict(flat(params)), dict(flat(stats))
    got_p, got_s = dict(flat(p2)), dict(flat(s2))
    assert ref_p.keys() == got_p.keys() and ref_s.keys() == got_s.keys()
    for k in ref_p:
        np.testing.assert_array_equal(got_p[k], ref_p[k])
    for k in ref_s:
        np.testing.assert_array_equal(got_s[k], ref_s[k])


def test_train_mode_batchnorm_statistics_match_flax(rng):
    x, jm, params, stats, tm = _backbone(10, True, rng)
    ref, mutated = jm.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
    out = tm.train()(T(x)).detach().numpy()
    ref = np.asarray(ref)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    want = resnet3d_state_dict_from_jax(params, _np_tree(
        mutated["batch_stats"]))
    got = tm.state_dict()
    n_checked = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)
            n_checked += 1
    assert n_checked == 2 * 12  # 12 BatchNorms at depth 10


def test_s2d_stem_kernel_is_exact(rng):
    torch.manual_seed(0)
    plain = ResNet3DBackbone(10, s2d_stem=False).eval()
    s2d = ResNet3DBackbone(10, s2d_stem=True).eval()
    sd = plain.state_dict()
    sd["conv1.weight"] = T(s2d_stem_kernel(sd["conv1.weight"].numpy()))
    s2d.load_state_dict(sd)
    x = T(rng.normal(size=(2, 8, 16, 12, 1)).astype(np.float32))
    np.testing.assert_allclose(s2d(x).detach().numpy(),
                               plain(x).detach().numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        space_to_depth_hw(torch.zeros(1, 4, 5, 4, 1))


def _fusion_pair(rng, variant="per_epoch_attn", dropout_inert=False):
    mri = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    pet = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    tv = rng.uniform(size=(512, 512)).astype(np.float32)
    tv /= tv.sum()
    jm = JaxFusion(depth=10, s2d_stem=True, variant=variant)
    variables = _np_tree(jm.init(jax.random.key(1), mri, pet, t_feature=tv,
                                 train=False))
    params, stats = variables["params"], variables["batch_stats"]
    for side in ("mri_backbone", "pet_backbone"):
        _randomize_bn(params[side], stats[side], rng)
    rates = dict(projection_dropout=0.0, attention_dropout=0.0) \
        if dropout_inert else {}
    tm = MultimodalOTFusion(depth=10, s2d_stem=True, variant=variant, **rates)
    tm.load_state_dict(fusion_state_dict_from_jax(params, stats))
    return (mri, pet, tv), jm, params, stats, tm


@pytest.mark.parametrize("variant", ["per_epoch_attn", "mmfusion"])
def test_fusion_forward_matches_jax(rng, variant):
    (mri, pet, tv), jm, params, stats, tm = _fusion_pair(rng, variant)
    ref = jm.apply({"params": params, "batch_stats": stats}, mri, pet,
                   t_feature=tv, train=False)
    out = tm.eval()(T(mri), T(pet), T(tv))
    assert out.keys() == ref.keys()
    for key in ref:
        if ref[key] is None:
            assert out[key] is None
            continue
        r = np.asarray(ref[key])
        o = out[key].detach().numpy()
        assert o.shape == r.shape, key
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4, err_msg=key)


def _inert_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    if isinstance(context.module, nn.MultiHeadDotProductAttention):
        # The module is built with deterministic=not train; flax refuses a
        # call-time value as well, so switch the attribute for this call.
        object.__setattr__(context.module, "deterministic", True)
    return next_fun(*args, **kwargs)


def test_one_train_step_matches_jax(rng):
    """One update from identical weights, dropout inert on both sides.

    The JAX side runs in float64: flax's BatchNorm takes the variance as
    E[x^2] - E[x]^2, and through the few-element BatchNorms of a depth-10
    net at 16^3 its float32 gradients lie up to ~1e-2 (relative) from its
    own float64 gradients. So the reference is the JAX package in float64:
    the port's float32 step is held to it on the losses and the new
    BatchNorm statistics, and on every gradient leaf to 1e-4 of the leaf's
    largest entry; a float64 copy of the port is held to it leaf by leaf
    with rtol 1e-3 and atol 1e-6."""
    (mri, pet, tv), _, params, stats, tm = _fusion_pair(
        rng, dropout_inert=True)
    labels = np.array([0, 1])

    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        jm = JaxFusion(depth=10, s2d_stem=True, dtype=jnp.float64)

        def loss_fn(p):
            out, mutated = jm.apply(
                {"params": p, "batch_stats": f64(stats)}, f64(mri), f64(pet),
                t_feature=f64(tv), train=True,
                rngs={"dropout": jax.random.key(3)}, mutable=["batch_stats"])
            ce = jax_ce(out["logits"], labels)
            ot = jax_cosine(out["mri_fused"], out["ot_mri_from_pet"])
            return ce + ot, (ce, ot, mutated["batch_stats"])

        with nn.intercept_methods(_inert_dropout):
            (loss, (ce, ot, new_stats)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(f64(params))
        grads, new_stats = _np_tree(grads), _np_tree(new_stats)

    tm64 = copy.deepcopy(tm).double()
    make_fusion_train_step(tm64, make_optimizer(tm64.parameters(), 1e-5))(
        T(mri).double(), T(pet).double(), T(labels), T(tv).double())
    optimizer = make_optimizer(tm.parameters(), 1e-5)
    step = make_fusion_train_step(tm, optimizer)
    met = step(T(mri), T(pet), T(labels), T(tv))
    for name, want in (("loss", loss), ("ce_loss", ce), ("ot_loss", ot)):
        assert float(met[name]) == pytest.approx(float(want), rel=1e-5), name

    want = fusion_state_dict_from_jax(grads, new_stats)
    grads64 = dict(tm64.named_parameters())
    n_params = 0
    for name, p in tm.named_parameters():
        ref = want[name].double().numpy()
        np.testing.assert_allclose(grads64[name].grad.numpy(), ref,
                                   rtol=1e-3, atol=1e-6, err_msg=name)
        assert (np.abs(p.grad.double().numpy() - ref).max()
                <= 1e-4 * np.abs(ref).max() + 1e-8), name
        n_params += 1
    assert n_params == len([k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))])
    got = tm.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)

    # the eval step after the update is finite and labelled
    ev = make_fusion_eval_step(tm)(T(mri), T(pet), T(labels), T(tv))
    assert ev["logits"].shape == (2, 2)
    assert torch.isfinite(ev["logits"]).all()


def test_adamw_matches_optax(rng):
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = optax.adamw(learning_rate=1e-3, weight_decay=1e-5)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in init.items()}
    opt = make_optimizer(list(tp.values()), 1e-3)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = T(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
    set_learning_rate(opt, 0.5)
    assert all(group["lr"] == 0.5 for group in opt.param_groups)


def test_plateau_scheduler_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.9, 0.91, 0.9, 0.9, 0.9, 0.89995, 0.5,
              0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    ours, ref = ReduceLROnPlateau(1e-3), JaxPlateau(1e-3)
    lrs = [ours.step(v) for v in losses]
    assert lrs == [ref.step(v) for v in losses]
    assert lrs[-1] < 1e-3


def test_losses_match_jax(rng):
    logits = rng.normal(size=(5, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 1, 0])
    assert float(cross_entropy(T(logits), T(labels))) == pytest.approx(
        float(jax_ce(jnp.asarray(logits), jnp.asarray(labels))), rel=1e-6)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    y = rng.normal(size=(4, 6)).astype(np.float32)
    assert float(cosine_alignment_loss(T(x), T(y))) == pytest.approx(
        float(jax_cosine(jnp.asarray(x), jnp.asarray(y))), rel=1e-6)
    x[0, 0] = np.nan
    assert float(cosine_alignment_loss(T(x), T(y))) == 0.0
    assert float(jax_cosine(jnp.asarray(x), jnp.asarray(y))) == 0.0
