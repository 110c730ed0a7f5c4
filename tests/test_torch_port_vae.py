"""The harness's VAE family against the JAX package, on the CPU.

``eval.vae.train_vae_model`` (``VAE_label`` and ``VAE``) and
``eval.preprocess.train_modality_vae`` step for step from JAX's initial
parameters with JAX's noise, their encoders and decoders on converted
weights, and the harness's VAE branches (registry, ``run_inner_cv``,
``run_all``, ``run_loo``, ``run_loo_latent``, the CLI's ``--latent-vae``)
with JAX's row layout and log keys.

JAX's trainers run their steps in one ``lax.scan`` and return only the last
step's losses. The references here run JAX's own trainer with ``lax.scan``
replaced by a Python loop over its own step function, jitted (and the
``jax.jit`` around the scan by the identity), which records the initial
parameters, each step's losses and each step's parameters: the JAX
functions themselves, one step at a time. The noise is JAX's:
``split(PRNGKey(seed + 1), steps)``, each key split into the X and Y draws
for the shared-latent VAE.

Tolerances: losses at every step within 1e-4 relative; after 1 and 10
steps 99.9 % of parameter entries within 1e-5 and every entry within
``2 lr steps`` (Adam moves an entry by about lr a step whatever its
gradient, so an entry whose gradient is rounding noise may move the other
way); encoders and decoders within 1e-5. The shared-latent VAE is held at
the reference grid's learning rate, 1e-4 (latent 8, not 128, for the
CPU). At 1e-3 a few generator entries have gradients of ~3e-8, which
Adam scales to steps of 0.75 lr; JAX's float32 gets them 1 % off, and
JAX's own jitted scan and this step-by-step run then part by 1.3e-3 in the
parameters and 1e-4 in the losses within 10 steps, while the port's
float32 and float64 steps agree to 1.2e-5 (``test_vae_match_step_float32
_tracks_float64``). The per-modality VAE is held at its default, 1e-3.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from otfusion_tpu.eval import harness as jax_harness
from otfusion_tpu.eval import preprocess as jax_pre
from otfusion_tpu.eval import vae as jax_vae
from otfusion_tpu_torch.cli import perturbot_eval
from otfusion_tpu_torch.eval import harness, preprocess, vae
from otfusion_tpu_torch.utils.convert import (
    modality_vae_state_from_jax,
    vae_match_state_from_jax,
)

from test_eval_harness import synthetic_screen

STEPS = 10
LR = 1e-4             # the reference grid's learning rate
MODALITY_LR = 1e-3    # train_modality_vae's default
VAE_EPS = (10.0, 8, LR)
LOSS = dict(rtol=1e-4, atol=0)
FWD = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def screen():
    return synthetic_screen(n_labels=3, n=20, d=12, dp=14, seed=20)


def _recorded(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``lax.scan`` run as a Python loop (and
    ``jax.jit`` as the identity); returns (result, carries, per-step
    outputs), the carries from the initial one on."""
    carries, outs = [], []
    jit = jax.jit

    def scan(f, init, xs):
        carry, step = init, jit(f)
        carries.append(carry)
        for x in xs:
            carry, y = step(carry, x)
            carries.append(carry)
            outs.append(y)
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", scan)
        mp.setattr(jax, "jit", lambda f, *a, **k: f)
        result = fn(*args, **kwargs)
    return result, carries, outs


def _jax_noise(seed, shapes):
    """JAX's normals per step: one key per step from PRNGKey(seed + 1),
    split once more per draw when there are two."""
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(seed + 1), STEPS):
        keys = jax.random.split(key) if len(shapes) == 2 else [key]
        draws.append([torch.from_numpy(np.array(jax.random.normal(k, s)))
                      for k, s in zip(keys, shapes)])
    return draws


@pytest.fixture(scope="module")
def jax_refs(screen):
    """Every JAX trainer reference of this file, computed once, in
    threads."""
    data = (screen["Xs_dict"], screen["Xt_dict"])
    calls = {
        "VAE_label": lambda: _recorded(jax_vae.train_vae_model, data,
                                       VAE_EPS, True, steps=STEPS),
        "VAE": lambda: _recorded(jax_vae.train_vae_model, data, VAE_EPS,
                                 False, steps=STEPS),
        "modality": lambda: _recorded(jax_pre.train_modality_vae,
                                      screen["Xs_dict"], 3, steps=STEPS,
                                      lr=MODALITY_LR),
    }
    # lax.scan is patched process-wide: the three run one after another.
    with ThreadPoolExecutor(1) as pool:
        return {k: pool.submit(fn).result() for k, fn in calls.items()}


def _params_close(state, params_state, lr_steps):
    """The port's parameters against JAX's (converted to the port's
    names): 99.9 % of the entries within 1e-5, all within 2 lr steps."""
    assert state.keys() == params_state.keys()
    got = np.concatenate([state[k].detach().numpy().ravel() for k in state])
    want = np.concatenate([params_state[k].numpy().ravel() for k in state])
    diff = np.abs(got - want)
    assert np.mean(diff <= 1e-5) >= 0.999, np.quantile(diff, 0.999)
    assert diff.max() <= 2 * lr_steps, diff.max()


@pytest.mark.parametrize("use_label", [True, False])
def test_vae_match_steps_match_jax(screen, jax_refs, use_label):
    """One step, then ten, of the shared-latent VAE from JAX's initial
    parameters with JAX's noise: every step's five losses, and the
    parameters after steps 1 and 10."""
    (_, log), carries, outs = jax_refs["VAE_label" if use_label else "VAE"]
    data = (screen["Xs_dict"], screen["Xt_dict"])
    model, batch = vae.init_vae_match(data, VAE_EPS[1], use_label,
                                      device="cpu")
    model.load_state_dict(vae_match_state_from_jax(carries[0][0]))
    gen_opt, disc_opt = vae.make_optimizers(model, LR)
    shapes = [(batch.xn.shape[0], VAE_EPS[1]), (batch.yn.shape[0],
                                                VAE_EPS[1])]
    for s, (nx, ny) in enumerate(_jax_noise(0, shapes)):
        got = vae.vae_match_step(model, gen_opt, disc_opt, batch, nx, ny,
                                 VAE_EPS[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(outs[s]), **LOSS)
        if s + 1 in (1, STEPS):
            _params_close(model.state_dict(),
                          vae_match_state_from_jax(carries[s + 1][0]),
                          LR * (s + 1))
    assert log["final_recon"] == pytest.approx(float(got[2]), rel=1e-4)


def test_modality_vae_steps_match_jax(screen, jax_refs):
    (_, log), carries, outs = jax_refs["modality"]
    model, xn = preprocess.init_modality_vae(screen["Xs_dict"], 3,
                                             device="cpu")
    model.load_state_dict(modality_vae_state_from_jax(carries[0][0]))
    opt = preprocess.make_adam(model.parameters(), MODALITY_LR)
    for s, (noise,) in enumerate(_jax_noise(0, [(xn.shape[0], 3)])):
        got = preprocess.modality_vae_step(model, opt, xn, noise)
        np.testing.assert_allclose(float(got[0]), float(outs[s]), **LOSS)
        if s + 1 in (1, STEPS):
            _params_close(model.state_dict(),
                          modality_vae_state_from_jax(carries[s + 1][0]),
                          MODALITY_LR * (s + 1))
    assert log["final_loss"] == pytest.approx(float(got[0]), rel=1e-4)


def test_vae_match_step_float32_tracks_float64(screen, jax_refs):
    """At lr 1e-3, off the reference grid, the port's float32 steps follow
    its own float64 steps from the same start and noise: losses within
    1e-5 relative at every step, parameters as against JAX."""
    data = (screen["Xs_dict"], screen["Xt_dict"])
    runs = []
    for dtype in (torch.float32, torch.float64):
        model, batch = vae.init_vae_match(data, 8, True, device="cpu")
        model.load_state_dict(vae_match_state_from_jax(
            jax_refs["VAE_label"][1][0][0]))
        model.to(dtype)
        batch = vae.VAEBatch(*(t.to(dtype) for t in batch))
        gen_opt, disc_opt = vae.make_optimizers(model, 1e-3)
        losses = [vae.vae_match_step(model, gen_opt, disc_opt, batch,
                                     nx.to(dtype), ny.to(dtype), 10.0)
                  for nx, ny in _jax_noise(0, [(60, 8), (60, 8)])]
        runs.append((torch.stack(losses).double().numpy(),
                     {k: v.double() for k, v in model.state_dict().items()}))
    (l32, s32), (l64, s64) = runs
    np.testing.assert_allclose(l32, l64, rtol=1e-5, atol=0)
    _params_close({k: v.float() for k, v in s32.items()},
                  {k: v.float() for k, v in s64.items()}, 1e-3 * STEPS)


def _port_vae(jax_model, use_label=True):
    model = vae.VAEMatchModel(
        jax_model.dim_x, jax_model.dim_y, jax_model.latent_dim,
        jax_model.n_labels, use_label,
        (jax_model.x_mean, jax_model.x_std, jax_model.y_mean,
         jax_model.y_std))
    model.load_state_dict(vae_match_state_from_jax(jax_model.params))
    return model


def test_vae_inference_matches_jax(screen, jax_refs):
    """``infer_from_Xs``, ``infer_from_Ys`` and ``predict_from_model`` on
    the weights JAX trained, converted; float64 out."""
    jax_model = jax_refs["VAE_label"][0][0]
    model = _port_vae(jax_model)
    xs, ys = screen["Xs_dict"], screen["Xt_dict"]
    for fn, dicts, dim in ((vae.infer_from_Xs, xs, 14),
                           (vae.infer_from_Ys, ys, 12)):
        got = fn(dicts, model, dim)
        want = getattr(jax_vae, fn.__name__)(dicts, jax_model, dim)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.float64
            np.testing.assert_allclose(got[k], want[k], **FWD)
    x = np.concatenate(list(xs.values()))
    got = vae.predict_from_model(x, model, 14)
    assert got.dtype == np.float64 and got.shape == (60, 14)
    np.testing.assert_allclose(
        got, jax_vae.predict_from_model(x, jax_model, 14),
        rtol=0, atol=1e-5 * float(np.abs(got).max()))


def test_modality_encode_decode_match_jax(screen, jax_refs):
    jax_model = jax_refs["modality"][0][0]
    model = preprocess.ModalityVAE(jax_model.dim, jax_model.latent_dim,
                                   jax_model.mean, jax_model.std)
    model.load_state_dict(modality_vae_state_from_jax(jax_model.params))
    x0 = np.asarray(screen["Xs_dict"][0])
    z = preprocess.encode(model, x0)
    np.testing.assert_allclose(z, jax_pre.encode(jax_model, x0), **FWD)
    rec = preprocess.decode(model, z)
    np.testing.assert_allclose(
        rec, jax_pre.decode(jax_model, z),
        rtol=0, atol=1e-5 * float(np.abs(rec).max()))
    lat = preprocess.encode_dict(model, screen["Xs_dict"])
    assert lat.keys() == screen["Xs_dict"].keys()
    assert all(v.shape == (20, 3) and v.dtype == np.float64
               for v in lat.values())


def test_trainers_keep_jax_log_keys_and_no_stats_drift(screen, jax_refs):
    """The port's own trainers (its seeded initialisation and generator):
    JAX's log keys, finite losses, float64 z-statistics with a zero std
    taken as 1."""
    data = (screen["Xs_dict"], screen["Xt_dict"])
    model, log = vae.train_vae_model(data, VAE_EPS, steps=3, device="cpu")
    assert log.keys() == jax_refs["VAE_label"][0][1].keys()
    assert all(np.isfinite(log[k]) for k in log if k.startswith("final"))
    assert model.x_mean.dtype == np.float64
    const = {k: np.concatenate([v, np.ones((v.shape[0], 1))], axis=1)
             for k, v in screen["Xs_dict"].items()}
    m, mlog = preprocess.train_modality_vae(const, 3, steps=3, device="cpu")
    assert m.std[-1] == 1.0 and m.mean[-1] == 1.0
    assert mlog.keys() == jax_refs["modality"][0][1].keys()
    assert len(mlog["losses"]) == 3


def test_vae_noise_is_shared_by_both_halves(screen):
    """Both halves of a step see the same draw: with the discriminator's
    learning rate 0 the step's disc loss is the one recomputed from the
    step's own latents."""
    data = (screen["Xs_dict"], screen["Xt_dict"])
    model, batch = vae.init_vae_match(data, 4, True, device="cpu")
    gen_opt, disc_opt = vae.make_optimizers(model, LR)
    for group in disc_opt.param_groups:
        group["lr"] = 0.0
    g = torch.Generator().manual_seed(3)
    nx = torch.randn((60, 4), generator=g)
    ny = torch.randn((60, 4), generator=g)
    with torch.no_grad():
        mux, lvx = model.enc_x(batch.xn)
        muy, lvy = model.enc_y(batch.yn)
        zx = mux + torch.exp(0.5 * lvx) * nx
        zy = muy + torch.exp(0.5 * lvy) * ny
        dx = model.discriminate(zx, batch.oh_x)
        dy = model.discriminate(zy, batch.oh_y)
        adv = torch.mean((dx - 0.5) ** 2) + torch.mean((dy - 0.5) ** 2)
    before = {k: v.clone() for k, v in model.disc.state_dict().items()}
    out = vae.vae_match_step(model, gen_opt, disc_opt, batch, nx, ny, 10.0)
    assert float(out[4]) == pytest.approx(float(adv), rel=1e-6)
    # the generator's backward leaves gradients in disc; its optimiser
    # (lr 0 here, moments advanced) never moves it
    for k, v in model.disc.state_dict().items():
        assert torch.equal(v, before[k])


# ------------------------------------------------------------ the harness


def test_vae_registry_no_longer_raises(screen):
    """``VAE``, ``VAE_label`` and ``run_loo_latent`` run (they raised
    ``NotImplementedError`` before the VAE family was ported); the kNN
    grids are JAX's."""
    assert harness.VAE_INNER_KS == jax_harness.VAE_INNER_KS
    assert harness.VAE_ALL_KS == jax_harness.VAE_ALL_KS
    assert harness.OT_METHOD_MAP["VAE"].keywords == {"use_label": False}
    data = (screen["Xs_dict"], screen["Xt_dict"])
    model, log = harness.OT_METHOD_MAP["VAE"](data, (5.0, 4, 1e-3),
                                              steps=2, device="cpu")
    assert not model.use_label and np.isfinite(log["final_gen_loss"])
    rows, _ = harness.run_loo_latent(screen, "EGW_ott", 1e-2, latent_dim=3,
                                     vae_steps=2, device="cpu")
    assert len(rows) == 3 * 4


@pytest.fixture
def fast_vae(monkeypatch):
    """The harness's VAE methods at 20 steps: the harness tests hold what
    the harness does with a model, not the training."""
    fast = {"VAE_label": partial(vae.train_vae_model, steps=20),
            "VAE": partial(vae.train_vae_model, use_label=False, steps=20)}
    monkeypatch.setattr(harness, "OT_METHOD_MAP",
                        {**harness.OT_METHOD_MAP, **fast})


def test_vae_inner_cv_branch(fast_vae):
    data = synthetic_screen(n_labels=10, n=8, d=6, dp=5, seed=21)
    eps = (5.0, 4, 1e-3)
    result = harness.run_inner_cv(data, "VAE_label", test_idx=0,
                                  epsilons=[eps], n_splits=2, device="cpu")
    assert result.keys() == {"matching_evals", "dfracs", "pred_evals",
                             "pred_mse", "T", "log", "best_eps",
                             "test_labels"}
    assert result["best_eps"] == {"matching": eps, "pred": eps}
    assert np.isfinite(result["matching_evals"][eps])
    assert isinstance(result["dfracs"][eps][0], dict)
    assert sorted(result["dfracs"][eps][0]) == [5]  # k <= 8 rows
    assert all(np.isfinite(d["MSE"]) for d in result["pred_evals"][eps])
    assert len(result["pred_evals"][eps]) == 5   # one per val label


def test_vae_run_all_and_loo_layout(fast_vae):
    data = synthetic_screen(n_labels=3, n=12, d=6, dp=5, seed=22)
    result = harness.run_all(data, "VAE", eps=(5.0, 4, 1e-3), device="cpu")
    me = result["matching_evals"]
    assert 0.0 <= me["mean_foscttm"] <= 1.0
    assert sorted(me["rel_dfracs"]) == sorted(me["dfracs"]) == [1, 5, 10]
    rows, log = harness.run_loo(data, "VAE_label", eps=(5.0, 4, 1e-3),
                                device="cpu")
    assert len(rows) == 3 and all(r["_id"] == "VAE" for r in rows)
    assert [r["loo_test_idx"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["MSE"]) for r in rows)
    assert set(log) == {"ot_couplings", "params", "preds", "logs",
                        "latent_X", "latent_Y", "pred_T_k1", "pred_T_k5",
                        "pred_T_k10"}
    assert log["preds"][0].shape == (12, 5)


def test_vae_outer_cv_fits_full_features(fast_vae):
    """With ``pred_data``, the VAE fits and predicts on the full features
    and is scored on their latents; no MLP."""
    data = synthetic_screen(n_labels=5, n=10, d=4, dp=3, seed=30)
    full = synthetic_screen(n_labels=5, n=10, d=7, dp=6, seed=31)
    result = harness.run_outer_cv(data, "VAE_label", 0, (5.0, 4, 1e-3),
                                  (5.0, 4, 1e-3), pred_data=full,
                                  device="cpu")
    assert result["T"]["match"].dim_x == 7
    assert result["pred"]["Y_pred"].shape == (10, 6)
    assert np.isnan(result["log"]["mlp"]["final_loss"])
    assert isinstance(result["matching_evals"]["rel_dfracs"], dict)


def test_run_loo_latent_layout(fast_vae):
    """VAE-then-OT leave-one-out with JAX's layout (its
    ``run_loo_latent``): per hold-out one ``ot_latent`` row and the three
    raw-space baselines, each tagged with the held-out label; the log's
    keys, the VAE logs' keys and the latents' width. A shared-latent VAE
    method is refused."""
    small = synthetic_screen(n_labels=3, n=8, d=5, dp=4, seed=5)
    rows, log = harness.run_loo_latent(small, "EGW_ott", 1e-2, latent_dim=3,
                                       vae_steps=20, device="cpu")
    ids = ["ot_latent"] + harness.BASELINE_PRED_LABELS
    assert [(r["_id"], r["loo_test_idx"]) for r in rows] == [
        (i, label) for label in (0, 1, 2) for i in ids]
    assert log.keys() == {"ot_couplings", "params", "preds", "logs",
                          "vae_logs", preprocess.SCVI_LATENT_KEY}
    assert log["vae_logs"][0].keys() == {"source", "target"}
    assert log["vae_logs"][0]["source"].keys() == {"final_loss", "losses"}
    lat_x, lat_y = log[preprocess.SCVI_LATENT_KEY][0]
    assert all(v.shape == (8, 3) for v in {**lat_x, **lat_y}.values())
    assert all(np.isfinite(r["MSE"]) for r in rows)
    assert log["preds"][0][0].shape == (8, 4)
    with pytest.raises(ValueError, match="shared-latent"):
        harness.run_loo_latent(small, "VAE", (1.0, 8, 1e-4), device="cpu")


def test_cli_loo_latent_vae(tmp_path, monkeypatch):
    """``loo --latent-vae`` through the CLI (its VAEs at 20 steps)."""
    train = preprocess.train_modality_vae
    monkeypatch.setattr(harness, "train_modality_vae",
                        lambda *a, steps, **k: train(*a, steps=20, **k))
    data = synthetic_screen(n_labels=3, n=8, d=5, dp=4, seed=5)
    path = tmp_path / "screen.pkl"
    path.write_bytes(pickle.dumps(data))
    assert perturbot_eval.main([
        "--device", "cpu", "--out-dir", str(tmp_path), "--quiet", "loo",
        "EGW_ott", str(path), "0.01", "--latent-vae", "--latent-dim",
        "3"]) == 0
    result = pickle.loads((tmp_path / "loo_vae_EGW_ott.0.01.pkl").read_bytes())
    assert len(result["evals"]) == 3 * 4
    assert "X_scVI" in result["log"]
    assert len(result["log"]["vae_logs"][0]["source"]["losses"]) == 20
