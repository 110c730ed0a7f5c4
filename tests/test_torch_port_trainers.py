"""The port's base, mmfusion, T1/T2 and unimodal trainers against the JAX
package, on the CPU.

  * one base train step (in-batch FOT inside the step) and ``grad_accum=2``
    steps of every fusion variant and of the unimodal classifier, against
    the JAX step factories from the same weights (a float64 reference,
    dropout inert): losses, every gradient leaf, BatchNorm statistics;
  * a batch that ``grad_accum`` does not divide takes the plain path;
  * ``ResNet3DClassifier`` forward and Adam against flax / optax;
  * ``fot`` is float32 under autocast, and the Sinkhorn diagnostics are
    tensors (no host read in the solve).

The four CLIs run end to end in tests/test_torch_port_trainer_cli.py.

Tolerances, and why. The JAX reference runs in float64: flax's BatchNorm
takes the variance as E[x^2] - E[x]^2, and through the few-element
BatchNorms of a depth-10 net its float32 gradients scatter up to ~1e-2 from
float64 (tests/test_torch_port_models.py). A float64 copy of the port is
held to it leaf by leaf (rtol 1e-3, atol 1e-6; measured within 3e-7 of each
leaf's largest entry): that is the parity check. The port's float32 step
is held to 1e-5 relative on the losses and 1e-5 absolute on the
statistics. On the gradients it is held to 1e-4 of each leaf's largest
entry for the whole batch of 4 (measured 6e-6), and to 1e-1 for
microbatches of 2 rows, with tests/test_grad_accum.py's reasoning: the
BatchNorms of a 2-row microbatch make float32 gradients follow the CPU's
reduction order (measured up to 2.5e-2 at 32^3 in the one thread these
tests use, and 7.6e-2 at 16^3, where the same step at eight threads gave
7.5e-5), while every fault the test is for (no 1/k, contiguous instead of
strided rows, statistics not threaded) is O(1). Those tests run at 32^3,
where the margin is widest.

The port's float32 steps run with oneDNN off: at the base step's shapes
oneDNN's float32 3-D convolution gives one entry of the MRI stem's weight
gradient 0.11 of the leaf's largest entry away from float64 (0.261 against
0.095, the same at 1, 4 and 16 threads), where PyTorch's own CPU
convolution stays within 3e-6. On the GPU the convolutions are cuDNN's.
"""

import copy
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.models.resnet3d import ResNet3DClassifier as JaxClassifier
from otfusion_tpu.ops import fot as jax_fot
from otfusion_tpu.train.steps import (
    make_fusion_train_step as jax_fusion_step,
    make_unimodal_train_step as jax_unimodal_step,
)
from otfusion_tpu.train.train_state import FusionTrainState
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import ResNet3DClassifier
from otfusion_tpu_torch.ops.fot import fot
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
from otfusion_tpu_torch.train.steps import (
    make_fusion_train_step,
    make_unimodal_eval_step,
    make_unimodal_train_step,
    micro_count,
)
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.utils.convert import (
    classifier_state_dict_from_jax,
    fusion_state_dict_from_jax,
)

T = torch.from_numpy
_STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are many small CPU ops, and the
    suite runs several test processes on the machine's cores at once, where
    PyTorch's default of a thread per core makes them wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _randomize_bn(params, stats, rng):
    """Random BN scale/bias and running statistics, in place (numpy)."""
    for key, sub in params.items():
        if key.startswith("BatchNorm"):
            c = sub["scale"].shape
            sub["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sub["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            stats[key]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            stats[key]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif isinstance(sub, dict) and key in stats:
            _randomize_bn(sub, stats[key], rng)


def _inert_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    if isinstance(context.module, nn.MultiHeadDotProductAttention):
        object.__setattr__(context.module, "deterministic", True)
    return next_fun(*args, **kwargs)


def _jax_reference(model, params, stats, step_factory, *args):
    """Run a JAX step factory's step (jitted, dropout inert) in float64
    from ``params``/``stats`` under SGD(1): returns (metrics, gradients,
    new batch_stats) as numpy trees."""
    with jax.enable_x64(True):
        state = FusionTrainState.create(
            apply_fn=model.apply, params=_f64(params),
            batch_stats=_f64(stats), tx=optax.sgd(1.0))
        args = [a if a is None or a.dtype.kind != "f" else _f64(a)
                for a in args]
        step = step_factory(model)
        with nn.intercept_methods(_inert_dropout):
            new, met = jax.jit(step)(state, *args, jax.random.key(3))
        grads = jax.tree_util.tree_map(lambda a, b: a - b, state.params,
                                       new.params)
        return (_np_tree(met), _np_tree(grads),
                _np_tree(new.batch_stats))


def _hold(tm, tm64, met, want, ref_met, keys, grad_rel):
    """The port's float32 step (``tm``, ``met``) and float64 copy
    (``tm64``) against the JAX reference state dict ``want`` of gradients
    and new statistics, and its metrics ``ref_met``."""
    for key in keys:
        assert float(met[key]) == pytest.approx(float(ref_met[key]),
                                                rel=1e-5, abs=1e-7), key
    assert int(met["correct"]) == int(ref_met["correct"])
    grads64 = dict(tm64.named_parameters())
    n_params = 0
    for name, p in tm.named_parameters():
        ref = want[name].double().numpy()
        np.testing.assert_allclose(grads64[name].grad.numpy(), ref,
                                   rtol=1e-3, atol=1e-6, err_msg=name)
        assert (np.abs(p.grad.double().numpy() - ref).max()
                <= grad_rel * np.abs(ref).max() + 1e-8), name
        n_params += 1
    assert n_params == len([k for k in want if not k.endswith(_STATS)])
    got = tm.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)


@functools.lru_cache(maxsize=None)
def _fusion_init():
    """The JAX fusion model's initial variables (the three variants share
    one tree; its init takes seconds, so it runs once per test process)."""
    x = np.zeros((1, 8, 8, 8, 1), np.float32)
    jm = JaxFusion(depth=10, s2d_stem=True, variant="mmfusion")
    return _np_tree(jax.jit(lambda: jm.init(jax.random.key(1), x, x,
                                            train=False))())


def _fusion_case(rng, variant, batch, side=16):
    mri = rng.normal(size=(batch, side, side, side, 1)).astype(np.float32)
    pet = rng.normal(size=(batch, side, side, side, 1)).astype(np.float32)
    labels = np.arange(batch) % 2
    tv = None
    if variant == "per_epoch_attn":
        tv = rng.uniform(size=(512, 512)).astype(np.float32)
        tv /= tv.sum()
    variables = copy.deepcopy(_fusion_init())
    params, stats = variables["params"], variables["batch_stats"]
    for side_name in ("mri_backbone", "pet_backbone"):
        _randomize_bn(params[side_name], stats[side_name], rng)
    tm = MultimodalOTFusion(depth=10, s2d_stem=True, variant=variant,
                            projection_dropout=0.0, attention_dropout=0.0)
    tm.load_state_dict(fusion_state_dict_from_jax(params, stats))
    return (mri, pet, labels, tv), params, stats, tm


def _run_fusion(rng, variant, batch, grad_accum, side=16):
    (mri, pet, labels, tv), params, stats, tm = _fusion_case(
        rng, variant, batch, side)
    base = variant == "base"
    fot_kw = dict(fot_threshold=0.0, fot_max_iterations=20)
    jm64 = JaxFusion(depth=10, s2d_stem=True, variant=variant,
                     dtype=jnp.float64)
    ref_met, grads, new_stats = _jax_reference(
        jm64, params, stats,
        lambda m: jax_fusion_step(m, in_batch_fot=base, jit=False,
                                  grad_accum=grad_accum, **fot_kw),
        mri, pet, labels, tv)
    want = fusion_state_dict_from_jax(grads, new_stats)

    def port_step(model, dtype):
        step = make_fusion_train_step(
            model, make_optimizer(model.parameters(), 1e-5),
            in_batch_fot=base, grad_accum=grad_accum, **fot_kw)
        with torch.backends.mkldnn.flags(enabled=False):
            return step(T(mri).to(dtype), T(pet).to(dtype), T(labels),
                        None if tv is None else T(tv).to(dtype))

    tm64 = copy.deepcopy(tm).double()
    port_step(tm64, torch.float64)
    met = port_step(tm, torch.float32)
    return tm, tm64, met, want, ref_met


def test_base_train_step_matches_jax(rng):
    """One base step: FOT on the batch's fused features inside the step
    (threshold 0 pins 21 iterations), its plan applied to pet_fused, CE +
    cosine loss, gradients through everything but the solve."""
    tm, tm64, met, want, ref = _run_fusion(rng, "base", 4, 1)
    assert float(met["ot_loss"]) > 0.0
    _hold(tm, tm64, met, want, ref, ("loss", "ce_loss", "ot_loss"), 1e-4)


@pytest.mark.parametrize("variant", ["per_epoch_attn", "base", "mmfusion"])
def test_fusion_grad_accum_matches_jax(rng, variant):
    """``grad_accum=2`` on a batch of 4: strided microbatches, BatchNorm
    statistics threaded through both, the mean gradient, one update."""
    tm, tm64, met, want, ref = _run_fusion(rng, variant, 4, 2, side=32)
    _hold(tm, tm64, met, want, ref, ("loss", "ce_loss", "ot_loss"), 1e-1)


@functools.lru_cache(maxsize=None)
def _classifier_init(num_classes):
    x = np.zeros((1, 8, 8, 8, 1), np.float32)
    jm = JaxClassifier(depth=10, num_classes=num_classes, s2d_stem=True)
    return _np_tree(jax.jit(lambda: jm.init(jax.random.key(2), x,
                                            train=False))())


def _classifier_case(rng, batch, side=16, num_classes=3):
    vol = rng.normal(size=(batch, side, side, side, 1)).astype(np.float32)
    variables = copy.deepcopy(_classifier_init(num_classes))
    params, stats = variables["params"], variables["batch_stats"]
    _randomize_bn(params["backbone"], stats["backbone"], rng)
    tm = ResNet3DClassifier(depth=10, num_classes=num_classes, s2d_stem=True)
    tm.load_state_dict(classifier_state_dict_from_jax(params, stats))
    return vol, params, stats, tm


def test_unimodal_grad_accum_matches_jax(rng):
    vol, params, stats, tm = _classifier_case(rng, 4, side=32)
    labels = np.array([0, 2, 1, 1])
    jm64 = JaxClassifier(depth=10, num_classes=3, s2d_stem=True,
                         dtype=jnp.float64)
    ref, grads, new_stats = _jax_reference(
        jm64, params, stats,
        lambda m: jax_unimodal_step(m, jit=False, grad_accum=2),
        vol, labels)
    want = classifier_state_dict_from_jax(grads, new_stats)
    tm64 = copy.deepcopy(tm).double()
    for model, dtype in ((tm64, torch.float64), (tm, torch.float32)):
        step = make_unimodal_train_step(
            model, make_optimizer(model.parameters(), 1e-3, kind="adam"),
            grad_accum=2)
        with torch.backends.mkldnn.flags(enabled=False):
            met = step(T(vol).to(dtype), T(labels))
    _hold(tm, tm64, met, want, ref, ("loss",), 1e-1)


@pytest.mark.parametrize("kind", ["fusion", "unimodal"])
def test_partial_batch_takes_the_plain_path(rng, kind):
    """n = 3 with grad_accum = 2: one microbatch, bit for bit the plain
    step."""
    assert micro_count(3, 2) == 1 and micro_count(4, 2) == 2
    assert micro_count(1, 2) == 1 and micro_count(4, 1) == 1
    torch.manual_seed(0)
    if kind == "fusion":
        model = MultimodalOTFusion(depth=10, s2d_stem=True, variant="base")
        batch = [T(rng.normal(size=(3, 8, 8, 8, 1)).astype(np.float32))
                 for _ in range(2)] + [torch.tensor([0, 1, 0])]
    else:
        model = ResNet3DClassifier(depth=10, num_classes=2, s2d_stem=True)
        batch = [T(rng.normal(size=(3, 8, 8, 8, 1)).astype(np.float32)),
                 torch.tensor([0, 1, 0])]
    results = []
    for grad_accum in (1, 2):
        m = copy.deepcopy(model)
        opt = make_optimizer(m.parameters(), 1e-3)
        if kind == "fusion":
            step = make_fusion_train_step(m, opt, in_batch_fot=True,
                                          grad_accum=grad_accum,
                                          fot_max_iterations=50)
            met = step(*batch, None, torch.Generator().manual_seed(5))
        else:
            met = make_unimodal_train_step(m, opt,
                                           grad_accum=grad_accum)(*batch)
        results.append((met, m.state_dict()))
    (met_a, sd_a), (met_b, sd_b) = results
    assert met_a.keys() == met_b.keys()
    for key in met_a:
        assert torch.equal(met_a[key], met_b[key]), key
    for key in sd_a:
        assert torch.equal(sd_a[key], sd_b[key]), key


def test_classifier_forward_matches_jax(rng):
    vol, params, stats, tm = _classifier_case(rng, 2)
    jm = JaxClassifier(depth=10, num_classes=3, s2d_stem=True)
    logits, feats = jax.jit(lambda v: jm.apply(
        {"params": params, "batch_stats": stats}, v, train=False))(vol)
    out = make_unimodal_eval_step(tm)(T(vol), torch.tensor([0, 1]))
    for got, ref in ((out["logits"], logits), (out["features"], feats)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(out["preds"].numpy(),
                                  np.asarray(logits).argmax(-1))


def test_adam_matches_optax(rng):
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    tx = optax.adam(learning_rate=1e-3)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in init.items()}
    opt = make_optimizer(list(tp.values()), 1e-3, kind="adam")
    assert isinstance(opt, torch.optim.Adam)
    assert opt.param_groups[0]["weight_decay"] == 0
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = T(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(list(tp.values()), 1e-3, kind="sgd")


def _fused_features(rng, b=4, d=64):
    """Correlated (b, d) feature rows, as the fusion MLPs give."""
    z = rng.normal(size=(b, 3))
    x = (z @ rng.normal(size=(3, d)) + 0.1 * rng.normal(size=(b, d)))
    y = (z @ rng.normal(size=(3, d)) + 0.1 * rng.normal(size=(b, d)))
    return x.astype(np.float32), y.astype(np.float32)


def test_fot_is_float32_under_autocast(rng):
    """The base step solves FOT inside a bf16 autocast region at eps 1e-3:
    the cost must stay float32, or the plan moves by far more than eps."""
    x, y = _fused_features(rng)
    ts = torch.eye(4) / 4
    kw = dict(epsilon=1e-3, max_iterations=2000, threshold=1e-3)
    plain = fot(T(x), T(y), ts, **kw)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        under = fot(T(x), T(y), ts, **kw)
    assert under.coupling.dtype == torch.float32
    assert int(under.n_iters) == int(plain.n_iters)
    np.testing.assert_array_equal(under.coupling.numpy(),
                                  plain.coupling.numpy())
    ref = jax_fot(jnp.asarray(x), jnp.asarray(y), jnp.eye(4) / 4, **kw)
    assert int(under.n_iters) == int(ref.n_iters)
    t_ref = np.asarray(ref.coupling)
    assert np.abs(under.coupling.numpy() - t_ref).max() <= 1e-3 * t_ref.max()


def test_solve_diagnostics_are_device_tensors(rng):
    """``n_iters``, ``converged`` and ``err`` come back as 0-d tensors on
    the cost's device, as JAX's device arrays do, so a caller inside a
    train step never waits for them."""
    cost = T(rng.uniform(size=(24, 20)).astype(np.float32))
    res = sinkhorn(cost, epsilon=0.05, scale_cost=True)
    for value, dtype in ((res.n_iters, torch.int32),
                         (res.converged, torch.bool),
                         (res.err, torch.float32)):
        assert isinstance(value, torch.Tensor)
        assert value.shape == () and value.dtype == dtype
        assert value.device == cost.device
    assert bool(res.converged) and int(res.n_iters) > 1
    x, y = _fused_features(rng, d=12)
    out = fot(T(x), T(y), torch.eye(4) / 4)
    assert isinstance(out.n_iters, torch.Tensor) and out.n_iters.shape == ()
    assert out.converged.dtype == torch.bool
