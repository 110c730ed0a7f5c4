"""The port's run lifecycle on the CPU, against the JAX package where it
has a counterpart:

  * ``--resume`` of the fusion and unimodal CLIs (ports of
    tests/test_review_fixes.py's resume tests, which also check that the
    resumed model and optimiser hold ``latest/``'s state when training
    starts, and that a resumed epoch draws an uninterrupted run's dropout
    stream) and the tri-state stem
    policy (ports of tests/test_round4_fixes.py's);
  * pretrained backbones: ``restore_backbone`` from a ``.pth`` (with the
    ``module.`` prefix and the ``model_state_dict`` wrapper) against the JAX
    package's graft on the same file, from a port unimodal checkpoint, and
    the ``--mri-pretrained``/``--pet-pretrained`` CLI flags;
  * ``--remat``: one train step in float64 against the plain step and the
    JAX package's remat step (loss, gradients, updated parameters, and the
    BatchNorm statistics updated once);
  * ``--profile-dir`` writes a trace that holds events.
"""

import copy
import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.models.resnet3d import ResNet3DBackbone as JaxBackbone
from otfusion_tpu.train.losses import cosine_alignment_loss as jax_cosine
from otfusion_tpu.train.losses import cross_entropy as jax_ce
from otfusion_tpu.utils.checkpoint import (
    restore_backbone as jax_restore_backbone,
)
from otfusion_tpu.utils.reporting import parse_results_file
from otfusion_tpu_torch.cli import (
    train_mmfusion,
    train_ot_attn,
    train_unimodal,
)
from otfusion_tpu_torch.data.synthetic import make_synthetic_adni
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import (
    ResNet3DBackbone,
    ResNet3DClassifier,
)
from otfusion_tpu_torch.train import loop
from otfusion_tpu_torch.train.loop import _resolve_stem, run_unimodal_training
from otfusion_tpu_torch.train.steps import make_fusion_train_step
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.utils.checkpoint import (
    restore_backbone,
    save_checkpoint,
)
from otfusion_tpu_torch.utils.convert import fusion_state_dict_from_jax
from tests.test_torch_port_models import (
    _fusion_pair,
    _inert_dropout,
    _np_tree,
)

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("adni")
    make_synthetic_adni(root, n_per_class=4, shape=(10, 10, 10))
    return root


def _rows(run):
    return [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]


def _assert_tensors_equal(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for key in want:
            _assert_tensors_equal(got[key], want[key], f"{what}.{key}")
    elif isinstance(want, torch.Tensor):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=what)
    else:
        assert got == want, what


def _watch_training(monkeypatch, step_maker, latest=None):
    """Spy on the loop: per trained epoch, the state of its dropout
    generator at the epoch's start (None without one); with ``latest``,
    assert when the first epoch starts that the model and optimiser the
    train step updates hold what ``latest/checkpoint.pt`` holds."""
    seen = {"streams": [], "checked": False}
    make_step = getattr(loop, step_maker)

    def spy_make(model, optimizer, **kw):
        seen["model"], seen["optimizer"] = model, optimizer
        return make_step(model, optimizer, **kw)

    run_epoch = loop._run_train_epoch

    def spy_epoch(train_step, loader, device, extra=()):
        if latest is not None and not seen["checked"]:
            saved = torch.load(latest / "checkpoint.pt", weights_only=False)
            _assert_tensors_equal(seen["model"].state_dict(),
                                  saved["model"], "model")
            got = seen["optimizer"].state_dict()["state"]
            assert got and all("exp_avg_sq" in v for v in got.values())
            _assert_tensors_equal(got, saved["optimizer"]["state"],
                                  "optimizer")
            seen["checked"] = True
        gen = extra[-1] if extra else None
        seen["streams"].append(None if gen is None else gen.get_state())
        return run_epoch(train_step, loader, device, extra)

    monkeypatch.setattr(loop, step_maker, spy_make)
    monkeypatch.setattr(loop, "_run_train_epoch", spy_epoch)
    return seen


def test_fusion_resume_continues_training(cohort, tmp_path, monkeypatch):
    """--resume restores the model, optimiser, scheduler and epoch, draws
    the dropout masks an uninterrupted run draws, and appends to the run's
    artifacts."""
    def flags(out):
        return ["--data-dir", str(cohort), "--save-path", str(out),
                "--batch-size", "2", "--target-shape", "10", "10", "10",
                "--val-fraction", "0.34", "--model-depth", "10",
                "--dtype", "float32", "--max-jax-samples", "4",
                "--gw-max-iterations", "30", "--device", "cpu"]

    whole = _watch_training(monkeypatch, "make_fusion_train_step")
    train_ot_attn.main(flags(tmp_path / "whole") + ["--epochs", "2"])
    out = tmp_path / "run"
    train_ot_attn.main(flags(out) + ["--epochs", "1"])
    assert (out / "latest" / "checkpoint.pt").exists()
    meta = json.loads((out / "latest.meta.json").read_text())
    assert meta["epoch"] == 1 and "sched_bad_epochs" in meta
    assert len(_rows(out)) == 1

    # resume to epoch 3: trains epochs 2-3 only, from latest/, appending
    resumed = _watch_training(monkeypatch, "make_fusion_train_step",
                              latest=out / "latest")
    train_ot_attn.main(flags(out) + ["--epochs", "3", "--resume"])
    assert resumed["checked"]
    first, second = whole["streams"][:2]
    assert not torch.equal(first, second)
    assert torch.equal(resumed["streams"][0], second)
    assert [r["epoch"] for r in _rows(out)] == [1, 2, 3]
    text = (out / "results.txt").read_text()
    assert text.count("Best Validation Loss:") == 1
    assert text.count("Epoch ") == 1  # one header
    row = parse_results_file(out / "results.txt")
    assert row is not None and 1 <= int(row["best_epoch"]) <= 3
    assert json.loads((out / "latest.meta.json").read_text())["epoch"] == 3


def test_unimodal_resume(cohort, tmp_path, monkeypatch):
    out = tmp_path / "uni"
    flags = ["--data-dir", str(cohort), "--save-path", str(out),
             "--batch-size", "2", "--target-shape", "10", "10", "10",
             "--val-fraction", "0.34", "--model-depth", "10",
             "--dtype", "float32", "--classes", "AD", "CN",
             "--device", "cpu"]
    train_unimodal.main(flags + ["--epochs", "2"])
    resumed = _watch_training(monkeypatch, "make_unimodal_train_step",
                              latest=out / "latest")
    train_unimodal.main(flags + ["--epochs", "3", "--resume"])
    assert resumed["checked"] and resumed["streams"] == [None]
    assert [r["epoch"] for r in _rows(out)] == [1, 2, 3]
    assert (out / "results.txt").read_text().count(
        "Best Validation Loss:") == 1


def test_resolve_stem_policy(tmp_path):
    """Fresh runs default to s2d; --resume keeps the recorded stem; an
    explicit flag contradicting the recorded stem raises."""
    run = tmp_path / "run"
    run.mkdir()
    assert _resolve_stem(None, False, str(run)) is True
    assert _resolve_stem(False, False, str(run)) is False
    assert _resolve_stem(True, False, str(run)) is True
    (run / "model_config.json").write_text(json.dumps({"s2d_stem": False}))
    assert _resolve_stem(None, True, str(run)) is False
    assert _resolve_stem(False, True, str(run)) is False
    with pytest.raises(ValueError, match="s2d_stem=False"):
        _resolve_stem(True, True, str(run))
    (run / "model_config.json").write_text(json.dumps({"s2d_stem": True}))
    assert _resolve_stem(None, True, str(run)) is True
    with pytest.raises(ValueError, match="s2d_stem=True"):
        _resolve_stem(False, True, str(run))
    run2 = tmp_path / "old_run"  # latest/ without a manifest: plain
    (run2 / "latest").mkdir(parents=True)
    assert _resolve_stem(None, True, str(run2)) is False
    assert _resolve_stem(None, True, str(tmp_path / "nowhere")) is True


def test_fresh_run_defaults_s2d_and_resume_keeps_plain(tmp_path):
    from otfusion_tpu_torch.data.datasets import NiftiDataset

    tree = make_synthetic_adni(tmp_path / "adni", n_per_class=3,
                               shape=(8, 8, 8))
    ds = NiftiDataset(str(tree))
    n = len(ds.samples)
    val_idx = list(range(0, n, 3))
    train_idx = [i for i in range(n) if i not in val_idx]
    common = dict(samples=ds.samples, train_idx=train_idx, val_idx=val_idx,
                  class_names=ds.class_names, model_depth=10,
                  target_shape=(8, 8, 8), batch_size=2, lr=1e-3, epochs=1,
                  seed=0, device=torch.device("cpu"), num_workers=1)
    fresh = tmp_path / "fresh"
    run_unimodal_training(save_path=str(fresh), **common)
    assert json.loads((fresh / "model_config.json").read_text())[
        "s2d_stem"] is True
    plain = tmp_path / "plain"
    run_unimodal_training(save_path=str(plain), s2d_stem=False, **common)
    res = run_unimodal_training(save_path=str(plain), resume=True,
                                **{**common, "epochs": 2})
    assert np.isfinite(res["best_val_loss"])
    assert json.loads((plain / "model_config.json").read_text())[
        "s2d_stem"] is False
    assert [r["epoch"] for r in _rows(plain)] == [1, 2]


def _seeded_plain_backbone(rng, depth=10):
    """A port ResNet3DBackbone (plain stem) with random BatchNorm."""
    torch.manual_seed(5)
    bb = ResNet3DBackbone(depth, s2d_stem=False)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                c = m.num_features
                m.weight.copy_(T(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(T(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(
                    T(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(
                    T(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return bb.eval()


@dataclasses.dataclass
class _JaxState:
    """The fields of a JAX train state that its backbone graft touches."""

    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@pytest.mark.parametrize("naming", ["classifier", "backbone"])
def test_restore_backbone_from_pth_matches_jax(rng, tmp_path, capsys,
                                               naming):
    """A .pth wrapped as the reference saves it, grafted into an s2d fusion
    model's MRI backbone by both packages: the same tensors load, and the
    grafted backbones' eval features agree to 1e-5."""
    src = _seeded_plain_backbone(rng)
    sd = {}
    for k, v in src.state_dict().items():
        if naming == "backbone":  # the reference backbone's stem names
            k = k.replace("conv1.", "stem.0.", 1) if k.startswith(
                "conv1.") else k.replace("bn1.", "stem.1.", 1) if \
                k.startswith("bn1.") else k
        sd["module." + k] = v
    pth = tmp_path / "mri.pth"
    torch.save({"model_state_dict": sd, "epoch": 3}, pth)

    x = rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32)
    jm = JaxBackbone(10, s2d_stem=True)
    v = _np_tree(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), x))
    state = _JaxState({"mri_backbone": v["params"]},
                      {"mri_backbone": v["batch_stats"]})
    state = jax_restore_backbone(state, pth, "mri_backbone", depth=10)
    jax_report = capsys.readouterr().out
    want = np.asarray(jm.apply(
        {"params": state.params["mri_backbone"],
         "batch_stats": state.batch_stats["mri_backbone"]}, x, train=False))

    model = MultimodalOTFusion(depth=10, s2d_stem=True)
    restore_backbone(model, pth, "mri_backbone")
    report = capsys.readouterr().out
    n_jax = int(jax_report.split("Grafted ")[1].split()[0])
    assert report.startswith(f"Grafted {n_jax} tensors") and n_jax > 0
    with torch.no_grad():
        got = model.mri_backbone.eval()(T(x)).numpy()
        plain = src(T(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-5)


def test_restore_backbone_from_port_checkpoint(rng, tmp_path):
    """A unimodal classifier's best_model (plain stem) grafted into an s2d
    fusion model's PET backbone: exact rewrite, BatchNorm statistics
    included."""
    clf = ResNet3DClassifier(depth=10, s2d_stem=False)
    clf.backbone.load_state_dict(_seeded_plain_backbone(rng).state_dict())
    save_checkpoint(tmp_path / "best_model", clf, {"epoch": 1}, block=True)
    model = MultimodalOTFusion(depth=10, s2d_stem=True)
    restore_backbone(model, tmp_path / "best_model", "pet_backbone")
    x = T(rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(
            model.pet_backbone.eval()(x).numpy(),
            clf.backbone.eval()(x).numpy(), rtol=1e-4, atol=1e-5)
    orbax_like = tmp_path / "jax_ckpt"
    (orbax_like / "_CHECKPOINT_METADATA").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        restore_backbone(model, orbax_like, "mri_backbone")


def test_pretrained_flags_graft_before_training(cohort, tmp_path, rng,
                                                capsys):
    """train_ot_attn --mri-pretrained <unimodal best_model> --pet-pretrained
    <.pth>: both grafts report loaded tensors (a plain-stem source onto the
    default s2d stem) and the run trains."""
    uni = tmp_path / "uni"
    train_unimodal.main([
        "--data-dir", str(cohort), "--save-path", str(uni),
        "--batch-size", "4", "--target-shape", "10", "10", "10",
        "--val-fraction", "0.34",
        "--model-depth", "10", "--dtype", "float32", "--classes", "AD", "CN",
        "--no-s2d-stem", "--epochs", "1", "--device", "cpu"])
    pth = tmp_path / "pet.pth"
    torch.save({"model_state_dict": {
        "module." + k: v
        for k, v in _seeded_plain_backbone(rng).state_dict().items()}}, pth)
    capsys.readouterr()
    out = tmp_path / "run"
    train_ot_attn.main([
        "--data-dir", str(cohort), "--save-path", str(out),
        "--batch-size", "4", "--target-shape", "10", "10", "10",
        "--val-fraction", "0.34",
        "--model-depth", "10", "--dtype", "float32", "--max-jax-samples",
        "4", "--gw-max-iterations", "30", "--epochs", "1", "--device", "cpu",
        "--mri-pretrained", str(uni / "best_model"),
        "--pet-pretrained", str(pth)])
    report = capsys.readouterr().out
    n_bb = sum(not k.endswith("num_batches_tracked")
               for k in ResNet3DBackbone(10).state_dict())
    for side in ("mri_backbone", "pet_backbone"):
        assert re.search(rf"Grafted {n_bb} tensors from \S+ into {side}",
                         report), report
    assert json.loads((out / "model_config.json").read_text())["s2d_stem"]
    assert len(_rows(out)) == 1


def _jax_step(params, stats, mri, pet, tv, labels, remat):
    """The JAX package's float64 train step (dropout inert): loss, grads,
    new batch statistics, and the AdamW-updated parameters."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        jm = JaxFusion(depth=10, s2d_stem=True, remat=remat,
                       dtype=jnp.float64)

        def loss_fn(p):
            out, mutated = jm.apply(
                {"params": p, "batch_stats": f64(stats)}, f64(mri), f64(pet),
                t_feature=f64(tv), train=True,
                rngs={"dropout": jax.random.key(3)}, mutable=["batch_stats"])
            ce = jax_ce(out["logits"], labels)
            ot = jax_cosine(out["mri_fused"], out["ot_mri_from_pet"])
            return ce + ot, mutated["batch_stats"]

        with nn.intercept_methods(_inert_dropout):
            (loss, new_stats), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(f64(params))
        tx = optax.adamw(learning_rate=1e-5, weight_decay=1e-5)
        p64 = f64(params)
        updates, _ = tx.update(grads, tx.init(p64), p64)
        new_params = optax.apply_updates(p64, updates)
        return (float(loss), _np_tree(grads), _np_tree(new_stats),
                _np_tree(new_params))


def test_remat_step_matches_plain_and_jax(rng):
    """One float64 train step with remat: the same loss, gradients, updated
    parameters and BatchNorm statistics as the plain step (to rounding) and
    as JAX's remat step; a second BatchNorm update in the recompute would
    move the statistics by another momentum step."""
    (mri, pet, tv), _, params, stats, tm = _fusion_pair(
        rng, dropout_inert=True)
    labels = np.array([0, 1])
    loss, grads, new_stats, new_params = _jax_step(
        params, stats, mri, pet, tv, labels, remat=True)

    models = {}
    for remat in (False, True):
        m = MultimodalOTFusion(depth=10, s2d_stem=True, remat=remat,
                               projection_dropout=0.0,
                               attention_dropout=0.0)
        m.load_state_dict(copy.deepcopy(tm.state_dict()))
        m = m.double()
        met = make_fusion_train_step(
            m, make_optimizer(m.parameters(), 1e-5))(
            T(mri).double(), T(pet).double(), T(labels), T(tv).double())
        assert float(met["loss"]) == pytest.approx(loss, rel=1e-6)
        models[remat] = m
    plain, remat = models[False], models[True]
    assert remat.mri_backbone.remat and not plain.mri_backbone.remat

    grads_sd = fusion_state_dict_from_jax(grads, new_stats)
    params_sd = fusion_state_dict_from_jax(new_params, new_stats)
    remat_params = dict(remat.named_parameters())
    for name, p in plain.named_parameters():
        r = remat_params[name]
        np.testing.assert_allclose(r.grad.numpy(), p.grad.numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(r.grad.numpy(),
                                   grads_sd[name].double().numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(r.detach().numpy(), p.detach().numpy(),
                                   rtol=0, atol=1e-15, err_msg=name)
        # AdamW's first update is lr * g / (|g| + eps) per entry: where the
        # gradients agree (|g| above their 1e-6 tolerance) the update is
        # held to 1 % of lr; elsewhere its size is still at most lr.
        lr = 1e-5
        step = np.abs(r.detach().numpy() - params_sd[name].double().numpy())
        sure = np.abs(grads_sd[name].double().numpy()) > 1e-6
        assert step[sure].max(initial=0) <= 1e-2 * lr, name
        assert step.max() <= 2 * lr, name
    got, base, before = remat.state_dict(), plain.state_dict(), \
        tm.state_dict()
    n_stats = 0
    for key, value in grads_sd.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), base[key].numpy(),
                                       rtol=0, atol=1e-12, err_msg=key)
            np.testing.assert_allclose(got[key].numpy(),
                                       value.double().numpy(), rtol=0,
                                       atol=1e-5, err_msg=key)
            assert not torch.equal(got[key].float(), before[key]), key
            n_stats += 1
    assert n_stats == 2 * 2 * 12  # mean and var of 12 BatchNorms, 2 sides


def test_remat_accum_and_profile_dir(cohort, tmp_path):
    """train_mmfusion --remat --grad-accum 2 --profile-dir: the run trains
    and epoch 1's train phase leaves a Chrome trace with events."""
    out = tmp_path / "mmfusion"
    prof = tmp_path / "prof"
    train_mmfusion.main([
        "--data-dir", str(cohort), "--save-path", str(out),
        "--batch-size", "4", "--target-shape", "10", "10", "10",
        "--val-fraction", "0.34",
        "--model-depth", "10", "--dtype", "float32", "--epochs", "1",
        "--device", "cpu", "--remat", "--grad-accum", "2",
        "--profile-dir", str(prof)])
    assert len(_rows(out)) == 1
    trace = json.loads((prof / "epoch1.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names), sorted(names)[:20]
