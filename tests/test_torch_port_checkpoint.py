"""The port's checkpoints (``otfusion_tpu_torch.utils.checkpoint``) on the
CPU: the write-behind semantics of the JAX package's
tests/test_async_checkpoint.py, the ``.old`` crash recovery, and the
serving BatchNorm fold and stem rewrite against the JAX functions on the
same weights (crossing through ``otfusion_tpu_torch.utils.convert``).
BatchNorm scales, biases and running statistics are randomised first.
"""

import copy
import functools
import os
import threading

import jax
import numpy as np
import pytest
import torch

from otfusion_tpu.models.fusion import MultimodalOTFusion as JaxFusion
from otfusion_tpu.models.resnet3d import ResNet3DBackbone as JaxBackbone
from otfusion_tpu.models.resnet3d import ResNet3DClassifier as JaxClassifier
from otfusion_tpu.utils.checkpoint import (
    fold_conv_bn_params as jax_fold_conv_bn_params,
)
from otfusion_tpu.utils.checkpoint import (
    rewrite_stem_params as jax_rewrite_stem_params,
)
from otfusion_tpu_torch.models.fusion import MultimodalOTFusion
from otfusion_tpu_torch.models.resnet3d import (
    ResNet3DBackbone,
    ResNet3DClassifier,
)
from otfusion_tpu_torch.train.train_state import make_optimizer
from otfusion_tpu_torch.utils import checkpoint as ckpt
from otfusion_tpu_torch.utils.checkpoint import (
    _PENDING,
    checkpoint_exists,
    flush_checkpoints,
    fold_conv_bn_params,
    fold_state_for_serving,
    load_metadata,
    restore_checkpoint,
    rewrite_stem_params,
    save_checkpoint,
)
from otfusion_tpu_torch.utils.convert import (
    classifier_state_dict_from_jax,
    fusion_state_dict_from_jax,
    resnet3d_state_dict_from_jax,
)
from tests.test_torch_port_models import _np_tree, _randomize_bn

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Tiny(torch.nn.Module):
    """A parameter and a buffer, filled with one value."""

    def __init__(self, value):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4, 4), float(value)))
        self.register_buffer("m", torch.full((4,), float(value)))


def _w(model):
    return model.w.detach().numpy()


def test_read_helpers_drain_pending_write(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint(d, _Tiny(3.0), {"epoch": 7})
    # No flush: each read helper waits for the worker.
    assert checkpoint_exists(d)
    assert load_metadata(d)["epoch"] == 7
    restored = _Tiny(0.0)
    restore_checkpoint(d, restored)
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 3.0))


def test_payload_is_snapshotted_not_aliased(tmp_path):
    """Mutating the live model and optimiser after the save (as the next
    ``optimizer.step()`` does, in place) must not reach the write."""
    d = tmp_path / "ckpt"
    model = _Tiny(1.0)
    opt = make_optimizer(model.parameters(), 1e-3)
    model.w.grad = torch.ones(4, 4)
    opt.step()
    want_w = _w(model).copy()
    want_moment = opt.state[model.w]["exp_avg"].clone()
    save_checkpoint(d, model, {"epoch": 1}, optimizer=opt)
    with torch.no_grad():
        model.w.fill_(-99.0)
        model.m.fill_(-99.0)
    opt.state[model.w]["exp_avg"].fill_(-99.0)
    flush_checkpoints()
    restored = _Tiny(0.0)
    ropt = make_optimizer(restored.parameters(), 1e-3)
    restore_checkpoint(d, restored, ropt)
    np.testing.assert_array_equal(_w(restored), want_w)
    np.testing.assert_array_equal(restored.m.numpy(), np.full(4, 1.0))
    torch.testing.assert_close(ropt.state[restored.w]["exp_avg"],
                               want_moment, rtol=0, atol=0)


def test_last_save_wins(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint(d, _Tiny(1.0), {"epoch": 1})
    save_checkpoint(d, _Tiny(2.0), {"epoch": 2})
    flush_checkpoints()
    assert load_metadata(d)["epoch"] == 2
    restored = _Tiny(0.0)
    restore_checkpoint(d, restored)
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 2.0))


def test_flush_propagates_worker_errors(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint(d, _Tiny(1.0))
    flush_checkpoints()
    # A file in the .tmp slot makes the worker's rmtree of it raise.
    tmp_slot = tmp_path / "ckpt.tmp"
    tmp_slot.write_text("in the way")
    save_checkpoint(d, _Tiny(2.0))
    with pytest.raises(OSError):
        flush_checkpoints()
    tmp_slot.unlink()
    # The error drained the pending write; the previous checkpoint stands.
    assert str(d.resolve()) not in _PENDING
    restored = _Tiny(0.0)
    restore_checkpoint(d, restored)
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 1.0))


def test_block_true_is_synchronous(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint(d, _Tiny(5.0), {"epoch": 1}, block=True)
    assert (d / ckpt.CHECKPOINT_FILE).exists()
    assert (tmp_path / "ckpt.meta.json").exists()
    assert str(d.resolve()) not in _PENDING


def test_backpressure_one_inflight_per_directory(tmp_path):
    """With the worker held busy, a second save to the same directory
    blocks until the first write has drained."""
    gate = threading.Event()
    fut = ckpt._executor().submit(gate.wait, 10)
    d = tmp_path / "ckpt"
    save_checkpoint(d, _Tiny(1.0))  # queued behind the gate
    assert not d.exists()
    t = threading.Thread(target=save_checkpoint, args=(d, _Tiny(2.0)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive()  # waiting on the write in flight to d
    gate.set()
    t.join(timeout=30)
    assert not t.is_alive()
    flush_checkpoints()
    assert fut.result(timeout=1) is True
    restored = _Tiny(0.0)
    restore_checkpoint(d, restored)
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 2.0))


def test_old_dir_crash_recovery(tmp_path):
    """A crash between the swap's renames leaves only ``<dir>.old``: the
    read helpers fall back to it, and the next save promotes it first."""
    d = tmp_path / "ckpt"
    save_checkpoint(d, _Tiny(1.0), {"epoch": 1}, block=True)
    os.rename(d, tmp_path / "ckpt.old")
    assert checkpoint_exists(d)
    restored = _Tiny(0.0)
    restore_checkpoint(d, restored)
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 1.0))
    assert load_metadata(d)["epoch"] == 1  # the sidecar keeps its name
    save_checkpoint(d, _Tiny(2.0), {"epoch": 2})
    flush_checkpoints()
    assert not (tmp_path / "ckpt.old").exists()
    restore_checkpoint(d, restored)
    np.testing.assert_array_equal(_w(restored), np.full((4, 4), 2.0))


def _init(jm):
    """``jm.init`` in eval mode, jitted (an eager init dispatches op by op,
    several times slower on the CPU)."""
    return jax.jit(functools.partial(jm.init, train=False))


def _jax_backbone(depth, s2d, rng):
    jm = JaxBackbone(depth, s2d_stem=s2d)
    x = np.zeros((1, 8, 8, 8, 1), np.float32)
    v = _np_tree(_init(jm)(jax.random.key(depth), x))
    _randomize_bn(v["params"], v["batch_stats"], rng)
    return v["params"], v["batch_stats"]


@pytest.mark.parametrize("depth,s2d", [(10, True), (50, False)])
def test_fold_conv_bn_params_matches_jax(rng, depth, s2d):
    params, stats = _jax_backbone(depth, s2d, rng)
    want = resnet3d_state_dict_from_jax(
        jax_fold_conv_bn_params(params, stats), {})
    got = fold_conv_bn_params(resnet3d_state_dict_from_jax(params, stats))
    assert got.keys() == want.keys()
    assert not any("bn" in k or "downsample.1" in k for k in got)
    folded = ResNet3DBackbone(depth, s2d_stem=s2d).fold_bn_()
    assert folded.state_dict().keys() == got.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=key)


def test_rewrite_stem_params_matches_jax(rng):
    plain, _ = _jax_backbone(10, False, rng)
    s2d, _ = _jax_backbone(10, True, rng)
    want = jax_rewrite_stem_params(plain, s2d)["_ConvBN_0"]["Conv_0"]
    src = {"conv1.weight": T(np.transpose(
        plain["_ConvBN_0"]["Conv_0"]["kernel"], (4, 3, 0, 1, 2)).copy())}
    dst = ResNet3DBackbone(10, s2d_stem=True).state_dict()
    got = rewrite_stem_params(src, dst)["conv1.weight"]
    assert tuple(got.shape) == tuple(dst["conv1.weight"].shape)
    np.testing.assert_array_equal(
        got.numpy(), np.transpose(want["kernel"], (4, 3, 0, 1, 2)))
    # equal shapes, or a layout the rewrite does not cover: unchanged
    same = ResNet3DBackbone(10, s2d_stem=False).state_dict()
    assert rewrite_stem_params(same, same) is same
    assert rewrite_stem_params(dst, same) is dst


def _jax_fusion(rng, x, tv):
    jm = JaxFusion(depth=10, s2d_stem=True)
    v = _np_tree(_init(jm)(jax.random.key(1), x, x, t_feature=tv))
    for side in ("mri_backbone", "pet_backbone"):
        _randomize_bn(v["params"][side], v["batch_stats"][side], rng)
    return v["params"], v["batch_stats"]


@pytest.mark.parametrize("kind", ["fusion", "unimodal"])
def test_folded_model_matches_jax_and_unfolded(rng, kind):
    """Eval logits in fp32 of the folded port model: within 1e-5 of JAX's
    folded model and 2e-5 of the unfolded port model."""
    x = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    if kind == "fusion":
        tv = rng.uniform(size=(512, 512)).astype(np.float32)
        tv /= tv.sum()
        params, stats = _jax_fusion(rng, x, tv)
        folded_params = dict(params)
        for side in ("mri_backbone", "pet_backbone"):
            folded_params[side] = jax_fold_conv_bn_params(params[side],
                                                          stats[side])
        want = np.asarray(JaxFusion(depth=10, s2d_stem=True, fold_bn=True)
                          .apply({"params": folded_params}, x, x,
                                 t_feature=tv, train=False)["logits"])
        model = MultimodalOTFusion(depth=10, s2d_stem=True)
        model.load_state_dict(fusion_state_dict_from_jax(params, stats))
        run = lambda m: m(T(x), T(x), T(tv))["logits"]  # noqa: E731
    else:
        jm = JaxClassifier(depth=10, s2d_stem=True)
        v = _np_tree(_init(jm)(jax.random.key(2), x))
        params, stats = v["params"], v["batch_stats"]
        _randomize_bn(params["backbone"], stats["backbone"], rng)
        folded_params = dict(params)
        folded_params["backbone"] = jax_fold_conv_bn_params(
            params["backbone"], stats["backbone"])
        want = np.asarray(JaxClassifier(depth=10, s2d_stem=True,
                                        fold_bn=True)
                          .apply({"params": folded_params}, x,
                                 train=False)[0])
        model = ResNet3DClassifier(depth=10, s2d_stem=True)
        model.load_state_dict(classifier_state_dict_from_jax(params, stats))
        run = lambda m: m(T(x))[0]  # noqa: E731
    # the folded layout loaded with the folded weights serves the same
    built = type(model)(depth=10, s2d_stem=True)
    for m in built.modules():
        if isinstance(m, ResNet3DBackbone):
            m.fold_bn_()
    built.load_state_dict(fold_conv_bn_params(model.state_dict()))
    with torch.no_grad():
        unfolded = run(model.eval()).numpy()
        folded_model = fold_state_for_serving(copy.deepcopy(model))
        got = run(folded_model).numpy()
        np.testing.assert_array_equal(run(built.eval()).numpy(), got)
    assert not any(isinstance(m, torch.nn.BatchNorm3d)
                   for m in folded_model.modules())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, unfolded, rtol=0, atol=2e-5)
    folded_model.train()
    with pytest.raises(ValueError, match="inference-only"):
        run(folded_model)
