"""The port's legacy GAMMA model and train step against the JAX package, on
the CPU, at a small size: fundus 32^2, OCT 16^3 (D' = 2, so d_oct = 1024),
a batch of 4 (two per label).

Weights cross from the JAX trees through
``utils.convert.legacy_state_dict_from_jax`` (BatchNorm scales, biases and
running statistics random); weights and inputs come from numpy with a
seed.
The JAX references are computed once per module, their compiles in
parallel threads. Tolerances:

  * the eval forward in float32: every output within 1e-4 of its largest
    entry;
  * in bf16 (``torch.autocast`` against the JAX module's bf16 dtype): the
    logits float32 on both sides and within 5e-2 of the largest;
  * one train step with dropout inert on both sides and JAX's own partner
    draws: the JAX step runs in float64 (through the few-element
    BatchNorms of these shapes float32 gradients are noise-limited, see
    ``test_torch_port_models.py``) and EGWL and FOT in float32, as the
    JAX code casts them. The port's float64 copy matches its losses to
    rtol 1e-6, every gradient leaf to 1e-4 of its largest entry (plus
    1e-9: the attention's key bias has a zero gradient), every updated
    parameter whose gradient is 0 or at least 1e-6 (AdamW's first update
    is then weight decay alone, or set by the sign; over 99 % of them) to
    1e-7, the rest within AdamW's 2 lr, and the new BatchNorm statistics to 1e-6. The float32 steps'
    losses carry the noise of the few-element BatchNorms of these shapes:
    the JAX step's lie 1.8e-3 from the float64 ones and the port's (one
    thread) 1.1e-3, each held to 5e-3;
  * EGWL under autocast: the plan of bf16 features under
    ``torch.autocast(bfloat16)`` is float32 and equal to the plan without
    autocast, and within the EGWL tolerance of ``test_torch_port_ot_api``
    (atol 1e-6, rtol 1e-3, the same ``n_iters``) of JAX's.
"""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from otfusion_tpu.models.legacy_fusion import (
    LegacyMultiModalFusion as JaxLegacy,
)
from otfusion_tpu.ops.fot import fot as jax_fot
from otfusion_tpu.ops.gromov import entropic_gw_labels as jax_egwl
from otfusion_tpu.train import legacy_steps as jax_steps
from otfusion_tpu.train.losses import cosine_alignment_loss as jax_cosine
from otfusion_tpu.train.losses import cross_entropy as jax_ce
from otfusion_tpu.train.train_state import FusionTrainState
from otfusion_tpu.train.train_state import make_optimizer as jax_optimizer
from otfusion_tpu_torch.models.legacy_fusion import (
    LegacyMultiModalFusion,
    probe_oct_dim,
)
from otfusion_tpu_torch.ops.gromov import egw_per_label, entropic_gw_labels
from otfusion_tpu_torch.ops.sinkhorn import sinkhorn
from otfusion_tpu_torch.train.legacy_steps import (
    make_legacy_eval_step,
    make_legacy_train_step,
    sample_partners,
)
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.utils.convert import legacy_state_dict_from_jax

T = torch.from_numpy
D_OCT = 1024
LR = 1e-4
LABELS = np.array([0, 1, 0, 1])
STEP_KEY = 7
GW_ITERS = 120


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _random_variables(rng, fundus, oct_vol, tv):
    """Variables of the JAX model's shapes (``jax.eval_shape``: compiling
    its init costs more than the rest of the module), drawn with numpy:
    kernels normal with std 1/sqrt(fan_in), biases small, BatchNorm scales,
    biases and running statistics random."""
    jm = JaxLegacy(num_classes=2, oct_feature_dim=D_OCT)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, fundus,
        oct_vol, tv, train=False))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            qkv = path[-2].key in ("query", "key", "value")  # (E, H, hd)
            fan_in = leaf.shape[0] if qkv else int(np.prod(leaf.shape[:-1]))
            return rng.standard_normal(leaf.shape, np.float32) / np.float32(
                np.sqrt(fan_in))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return variables["params"], variables["batch_stats"]


def _inert_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    if isinstance(context.module, nn.MultiHeadDotProductAttention):
        object.__setattr__(context.module, "deterministic", True)
    return next_fun(*args, **kwargs)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_eval(dtype, variables, fundus, oct_vol, tv):
    model = JaxLegacy(num_classes=2, oct_feature_dim=D_OCT, dtype=dtype)
    out = jax.jit(lambda v, f, o, t: model.apply(v, f, o, t, train=False))(
        variables, fundus, oct_vol, tv)
    return _np_tree(out)


def _jax_step_f64(params, stats, fundus, oct_vol):
    """The JAX legacy train step (``otfusion_tpu.train.legacy_steps``) in
    float64 with dropout inert: its loss and AdamW update composed from the
    JAX package's functions in the step's order, the partners drawn by its
    ``_sample_partners`` with the step's key split. The JAX step itself
    cannot run in float64: its EGWL and FOT cast to float32 and are not
    float64-clean, so here they run in float32 outside the float64 scope on
    the float64 features, as the step casts them. Returns (metrics,
    gradients, new params, new batch_stats, partners)."""
    model = JaxLegacy(num_classes=2, oct_feature_dim=D_OCT, dtype=jnp.float64)
    labels = jnp.asarray(LABELS)
    _, _, _, rng_s1, rng_s2 = jax.random.split(jax.random.key(STEP_KEY), 5)
    with jax.enable_x64(True):
        variables = {"params": _f64(params), "batch_stats": _f64(stats)}
        f_feat, o_feat = _np_tree(jax.jit(lambda v, f, o: model.apply(
            v, f, o, train=True, mutable=["batch_stats"],
            method=model.encode)[0])(variables, _f64(fundus), _f64(oct_vol)))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    t_f2o = jax_egwl(f32(f_feat), f32(o_feat), labels, labels, epsilon=5e-3,
                     max_iterations=GW_ITERS).coupling
    t_o2f = jax_egwl(f32(o_feat), f32(f_feat), labels, labels, epsilon=5e-3,
                     max_iterations=GW_ITERS).coupling
    tv = np.asarray(jax_fot(f32(o_feat), f32(f_feat), t_f2o.T,
                            epsilon=5e-3).coupling)
    idx_oct = np.asarray(jax_steps._sample_partners(rng_s1, t_f2o))
    idx_fundus = np.asarray(jax_steps._sample_partners(rng_s2, t_o2f))

    with jax.enable_x64(True):
        def loss_fn(p, stats, fundus, oct_vol, tv, idx_oct, idx_fundus):
            def apply(method, *args, **kw):
                return model.apply(
                    {"params": p, "batch_stats": stats},
                    *args, train=True, mutable=["batch_stats"],
                    method=method, **kw)

            (f, o), mutated = apply(model.encode, fundus, oct_vol)
            f_sg, o_sg = jax.lax.stop_gradient(f), jax.lax.stop_gradient(o)
            pred_oct, _ = apply(model.project_fundus2oct, f)
            pred_fundus, _ = apply(model.project_oct2fundus, o)
            ot = (jax_cosine(pred_oct, o_sg[idx_oct])
                  + jax_cosine(pred_fundus, f_sg[idx_fundus]))
            (logits, _), _ = apply(model.fuse, f, o, tv, pred_oct=pred_oct,
                                   pred_fundus=pred_fundus)
            ce = jax_ce(logits, labels)
            return ce + ot, (ce, ot, logits, mutated["batch_stats"])

        # every array an argument: XLA would constant-fold closed-over ones
        with nn.intercept_methods(_inert_dropout):
            (loss, (ce, ot, logits, new_stats)), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(
                    variables["params"], variables["batch_stats"],
                    _f64(fundus), _f64(oct_vol), _f64(tv), idx_oct,
                    idx_fundus)
        tx = jax_optimizer(LR, 1e-5, "adamw")
        new_params = jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(grads, variables["params"])
        met = {"loss": loss, "ce_loss": ce, "ot_loss": ot,
               "correct": jnp.sum(jnp.argmax(logits, -1) == labels)}
        return (_np_tree(met), _np_tree(grads), _np_tree(new_params),
                _np_tree(new_stats), (idx_oct, idx_fundus))


@pytest.fixture(scope="module")
def pair():
    """The JAX model's variables, the port's model
    loaded from them, the inputs and every JAX reference."""
    rng = np.random.default_rng(0)
    fundus = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    oct_vol = rng.normal(size=(4, 16, 16, 16, 1)).astype(np.float32)
    tv = rng.uniform(size=(D_OCT, 2048)).astype(np.float32)
    tv /= tv.sum()
    params, stats = _random_variables(rng, fundus, oct_vol, tv)
    variables = {"params": params, "batch_stats": stats}
    with ThreadPoolExecutor(3) as pool:
        jobs = {
            "f32": pool.submit(_jax_eval, jnp.float32, variables, fundus,
                               oct_vol, tv),
            "bf16": pool.submit(_jax_eval, jnp.bfloat16, variables, fundus,
                                oct_vol, tv),
            "step64": pool.submit(_jax_step_f64, params, stats, fundus,
                                  oct_vol),
        }
        refs = {k: job.result() for k, job in jobs.items()}
    tm = LegacyMultiModalFusion(num_classes=2, oct_feature_dim=D_OCT,
                                oct_input_depth=16)
    tm.load_state_dict(legacy_state_dict_from_jax(params, stats))
    return {"inputs": (fundus, oct_vol, tv), "params": params,
            "stats": stats, "model": tm, "refs": refs}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(out, ref, rel, key):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, key
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max(), key


def test_probe_oct_dim_matches_the_encoder():
    assert probe_oct_dim((16, 16, 16)) == D_OCT
    assert probe_oct_dim((96, 96, 96)) == 6144
    assert probe_oct_dim((20, 16, 16)) == 512 * 3  # ceil at each halving


def test_eval_forward_matches_jax(pair):
    fundus, oct_vol, tv = pair["inputs"]
    ref = pair["refs"]["f32"]
    out = make_legacy_eval_step()(pair["model"], T(fundus), T(oct_vol),
                                  T(LABELS), T(tv))
    full = pair["model"].eval()(T(fundus), T(oct_vol), T(tv))
    assert full.keys() == ref.keys()
    for key in ref:
        _close(full[key].detach().numpy(), ref[key], 1e-4, key)
    _close(out["logits"].numpy(), ref["logits"], 1e-4, "eval step")
    np.testing.assert_array_equal(out["preds"].numpy(),
                                  ref["logits"].argmax(-1))


def test_bf16_logits_are_float32_on_both_sides(pair):
    fundus, oct_vol, tv = pair["inputs"]
    ref = pair["refs"]["bf16"]["logits"]
    model = pair["model"].eval()
    with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
        out = model(T(fundus), T(oct_vol), T(tv))
    assert ref.dtype == np.float32
    assert out["logits"].dtype == torch.float32
    assert out["ot_fundus_from_oct"].dtype == torch.float32
    assert out["pred_oct"].dtype == torch.bfloat16
    _close(out["logits"].float().numpy(), ref, 5e-2, "bf16 logits")


def test_width_mismatch_raises():
    """A model built for 1000-d OCT features meets 16^3 volumes (1024-d);
    shapes alone decide, so it runs on the meta device."""
    with torch.device("meta"):
        model = LegacyMultiModalFusion(num_classes=2, oct_feature_dim=1000,
                                       oct_input_depth=16).eval()
        with pytest.raises(ValueError, match="OCT encoder produced 1024-d"):
            model.encode(torch.zeros(2, 32, 32, 3),
                         torch.zeros(2, 16, 16, 16, 1))


def test_one_train_step_matches_jax(pair):
    fundus, oct_vol, _ = pair["inputs"]
    met, grads, new_params, new_stats, draws = pair["refs"]["step64"]
    idx_oct, idx_fundus = draws
    assert idx_oct.shape == idx_fundus.shape == (4,)
    # partners share the row's label: the plans are label-masked
    np.testing.assert_array_equal(LABELS[idx_oct], LABELS)
    np.testing.assert_array_equal(LABELS[idx_fundus], LABELS)

    def jax_draws(t_f2o, t_o2f, generator):
        return T(idx_oct.copy()), T(idx_fundus.copy())

    def port_step(model, dtype):
        optimizer = make_optimizer(model.parameters(), LR)
        step = make_legacy_train_step(
            model, optimizer, gw_max_iterations=GW_ITERS,
            sample_partners=jax_draws)
        with torch.backends.mkldnn.flags(enabled=False):
            return step(T(fundus).to(dtype), T(oct_vol).to(dtype),
                        T(LABELS), None)

    rates = dict(projection_dropout=0.0, attention_dropout=0.0)
    tm64 = LegacyMultiModalFusion(num_classes=2, oct_feature_dim=D_OCT,
                                  oct_input_depth=16, **rates)
    tm64.load_state_dict(pair["model"].state_dict())
    tm64 = tm64.double()
    got64 = port_step(tm64, torch.float64)
    for name in ("loss", "ce_loss", "ot_loss"):
        assert float(got64[name]) == pytest.approx(float(met[name]),
                                                   rel=1e-6), name
    assert int(got64["correct"]) == int(met["correct"])

    want_grads = legacy_state_dict_from_jax(grads, new_stats)
    want = legacy_state_dict_from_jax(new_params, new_stats)
    n_params = n_updates = n_checked = 0
    for name, p in tm64.named_parameters():
        g = want_grads[name].double().numpy()
        assert (np.abs(p.grad.numpy() - g).max()
                <= 1e-4 * np.abs(g).max() + 1e-9), name
        # AdamW's first update is lr * g / (|g| + 1e-8): set by the sign
        # wherever |g| is well above 1e-8, and by weight decay alone where
        # g is 0 (taps of the dilated OCT convs that only read padding,
        # dead ReLU units)
        firm = (np.abs(g) >= 1e-6) | (np.abs(g) <= 1e-12)
        diff = np.abs(p.detach().numpy() - want[name].double().numpy())
        assert diff.max() <= 2.0 * LR + 1e-7, name
        assert (diff[firm].max(initial=0.0)) <= 1e-7, name
        n_params += 1
        n_updates += g.size
        n_checked += int(firm.sum())
    assert n_params == len([k for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))])
    assert n_checked >= 0.99 * n_updates
    got = tm64.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       rtol=0, atol=1e-6, err_msg=key)


def test_sample_partners_is_categorical_over_the_plan():
    """The default draw: rows follow their plan row, dead rows are
    uniform, and the draw reads nothing from the host."""
    plan = torch.tensor([[0.0, 0.7, 0.3], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([sample_partners(plan, g) for _ in range(4000)])
    assert set(draws[:, 0].tolist()) == {1, 2}
    assert abs(float((draws[:, 0] == 1).float().mean()) - 0.7) < 0.03
    assert set(draws[:, 1].tolist()) == {0, 1, 2}
    assert (draws[:, 2] == 0).all()


def _bf16_features(seed, n, d):
    rng = np.random.default_rng(seed)
    return T(rng.normal(size=(n, d)).astype(np.float32)).to(torch.bfloat16)


def test_egwl_is_float32_under_autocast():
    """EGWL on bf16 features (2 labels x 8 rows) under
    ``torch.autocast("cpu", torch.bfloat16)``: a float32 plan equal to the
    one without autocast, and JAX's within the EGWL tolerance. Before the
    solver turned autocast off, its self-costs and linearisations ran in
    bf16 here (296 against 208 iterations, the plan 0.33 of max T away)."""
    labels = T(np.repeat([0, 1], 8))
    x, y = _bf16_features(1, 16, 24), _bf16_features(2, 16, 40)
    plain = entropic_gw_labels(x, y, labels, labels, epsilon=1e-2)
    with torch.autocast("cpu", torch.bfloat16):
        auto = entropic_gw_labels(x, y, labels, labels, epsilon=1e-2)
    assert auto.coupling.dtype == torch.float32
    assert int(auto.n_iters) == int(plain.n_iters)
    torch.testing.assert_close(auto.coupling, plain.coupling, rtol=0, atol=0)
    ref = jax_egwl(jnp.asarray(x.float().numpy()), jnp.asarray(y.float().numpy()),
                   jnp.asarray(labels.numpy()), jnp.asarray(labels.numpy()),
                   epsilon=1e-2)
    assert int(ref.n_iters) == int(auto.n_iters)
    np.testing.assert_allclose(auto.coupling.numpy(), np.asarray(ref.coupling),
                               atol=1e-6, rtol=1e-3)


def test_per_label_gw_and_sinkhorn_are_float32_under_autocast():
    """The other public solvers under the same autocast: the per-label GW
    (its self-costs and final cost are products) and Sinkhorn give the
    plans they give without it."""
    x = torch.stack([_bf16_features(3, 8, 24), _bf16_features(4, 8, 24)])
    y = torch.stack([_bf16_features(5, 8, 40), _bf16_features(6, 8, 40)])
    mask = torch.ones(2, 8, dtype=torch.bool)
    cost = _bf16_features(7, 12, 9).float() ** 2
    plain = egw_per_label(x, y, mask, mask, epsilon=1e-2)
    plain_s = sinkhorn(cost, epsilon=1e-2)
    with torch.autocast("cpu", torch.bfloat16):
        auto = egw_per_label(x, y, mask, mask, epsilon=1e-2)
        auto_s = sinkhorn(cost, epsilon=1e-2)
    assert auto.coupling.dtype == auto_s.coupling.dtype == torch.float32
    assert auto.n_iters.tolist() == plain.n_iters.tolist()
    torch.testing.assert_close(auto.coupling, plain.coupling, rtol=0, atol=0)
    torch.testing.assert_close(auto.cost, plain.cost, rtol=0, atol=0)
    torch.testing.assert_close(auto_s.coupling, plain_s.coupling, rtol=0,
                               atol=0)
