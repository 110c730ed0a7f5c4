"""The port's model zoo against the JAX package's, on the CPU.

Each family (MedicalNet, Res2Net, Swin, UNETR) at a tiny size. The weights
start as the port module's seeded init with random BatchNorm scales,
biases and running statistics; the JAX package's own torch importer
(``otfusion_tpu.utils.torch_import``) turns them into the JAX module's
tree, and ``otfusion_tpu_torch.utils.convert`` turns that tree back into
the state dict the port runs (which must give back every tensor). Inputs
come from numpy with a seed. Each family is held to its JAX module in eval
mode, and MedicalNet and Res2Net with train-mode BatchNorm statistics (in
float64 on both sides: a BatchNorm over the few elements of a tiny
network's last stage differs in float32 by the variance's formula alone).
Also the registry's names and widths, the zoo BatchNorm fold against the
unfolded model and its folded weights against JAX's ``fold_zoo_conv_bn``
(to 1e-5 relative, 1e-6 absolute), and each family's
``.pth`` graft against JAX's from the same synthetic official-layout state
dict (the generators of ``test_torch_import_zoo.py``).

JAX runs under ``jax.jit`` (op-by-op dispatch of these modules costs 5 to
20 s each on the CPU). Tolerances: outputs within 1e-4 of the reference's
largest entry (1e-6 for the float64 runs, whose outputs both modules
round to float32 last); running statistics 1e-7 absolute (JAX keeps
them in float32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from otfusion_tpu.models.medicalnet import MedicalNetResNet as JaxMedicalNet
from otfusion_tpu.models.res2net import Res2Net as JaxRes2Net
from otfusion_tpu.models.swin import SwinTransformer2D as JaxSwin
from otfusion_tpu.models.unetr import UNETRViTEncoder as JaxUNETR
from otfusion_tpu.utils.checkpoint import fold_zoo_conv_bn as jax_fold_zoo
from otfusion_tpu.utils.torch_import import (
    _graft,
    medicalnet_tree_from_torch,
    res2net_tree_from_torch,
    swin_tree_from_torch,
    unetr_vit_tree_from_torch,
)
from otfusion_tpu_torch.models import registry
from otfusion_tpu_torch.models.medicalnet import MedicalNetResNet
from otfusion_tpu_torch.models.res2net import Res2Net
from otfusion_tpu_torch.models.resnet3d import (
    FlaxBatchNorm3d,
    FoldableBackbone,
)
from otfusion_tpu_torch.models.swin import SwinTransformer2D
from otfusion_tpu_torch.models.unetr import UNETRViTEncoder
from otfusion_tpu_torch.utils.checkpoint import fold_zoo_conv_bn
from otfusion_tpu_torch.utils.convert import backbone_state_dict_from_jax
from otfusion_tpu_torch.utils.torch_import import graft_torch_backbone
from test_torch_import_zoo import (
    _medicalnet10_sd,
    _res2net_sd,
    _tiny_swin_sd,
    _unetr_sd,
)

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, rel=1e-4):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max(), \
        np.abs(out - ref).max()


def _pooled(out):
    return out[1] if isinstance(out, tuple) else out


# name -> (registry spec, JAX module, port module, input shape, importer)
def _medicalnet(shortcut, pool):
    return ("medicalnet-10",
            JaxMedicalNet(depth=10, shortcut_type=shortcut, pool=pool),
            MedicalNetResNet(10, shortcut_type=shortcut, pool=pool,
                             input_depth=24),
            (2, 24, 16, 16, 1),
            functools.partial(medicalnet_tree_from_torch, depth=10))


def _res2net():
    return ("res2net50_v1b_26w_4s", JaxRes2Net(layers=(1, 1, 1, 1)),
            Res2Net(layers=(1, 1, 1, 1)), (2, 32, 32, 3),
            functools.partial(res2net_tree_from_torch, layers=(1, 1, 1, 1)))


def _swin():
    # 40^2 / patch 4 = 10^2, padded to 12^2 for window 4; stage 1 at 5^2
    # pads to 8^2 and its odd block shifts by 2; the merge sees unequal
    # quadrants at 10^2
    kw = dict(embed_dim=16, depths=(2, 2), heads=(2, 4), window=4,
              drop_path_rate=0.0, remat=False)
    return ("swin_base_384", JaxSwin(**kw),
            SwinTransformer2D(img_size=(40, 40), **kw), (2, 40, 40, 3),
            swin_tree_from_torch)


def _unetr():
    kw = dict(hidden=64, layers=2, heads=4, patch_size=8)
    return ("unetr_vit", JaxUNETR(**kw),
            UNETRViTEncoder(img_size=(16, 16, 24), **kw), (2, 16, 16, 24, 1),
            functools.partial(unetr_vit_tree_from_torch, heads=4))


FAMILIES = {
    "medicalnet-A-hw": lambda: _medicalnet("A", "hw"),
    "medicalnet-B-hw": lambda: _medicalnet("B", "hw"),
    "medicalnet-B-full": lambda: _medicalnet("B", "full"),
    "res2net": _res2net,
    "swin": _swin,
    "unetr": _unetr,
}


def _randomize_bn(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FlaxBatchNorm3d):
                c = m.num_features
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c)),
                             (m.running_mean, rng.normal(0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c))):
                    t.copy_(T(v))


def _numpy_sd(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _pair(name, rng):
    """(spec, input, JAX module, params, stats, port module); the port's
    weights came back through ``convert`` from the JAX tree."""
    spec, jm, tm, shape, importer = FAMILIES[name]()
    torch.manual_seed(0)
    _randomize_bn(tm, rng)
    sd = _numpy_sd(tm)
    params, stats = importer(sd)
    back = backbone_state_dict_from_jax(spec, params, stats)
    assert back.keys() - {k for k in back if "num_batches" in k} == sd.keys()
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    tm.load_state_dict(back)
    x = rng.normal(size=shape).astype(np.float32)
    return spec, x, jm, params, stats, tm


def _apply(jm, params, stats, x, train=False):
    fn = jax.jit(functools.partial(jm.apply, train=train,
                                   mutable=["batch_stats"] if train
                                   else False))
    return fn({"params": params, "batch_stats": stats}, x)


_EVAL_FNS = {}


def _eval_apply(name, params, stats, x):
    """The family's JAX eval forward, compiled once per family for the
    file (the eval and graft tests share a family's geometry)."""
    if name not in _EVAL_FNS:
        jm = FAMILIES[name]()[1]
        _EVAL_FNS[name] = jax.jit(functools.partial(jm.apply, train=False))
    return _EVAL_FNS[name]({"params": params, "batch_stats": stats}, x)


@pytest.mark.parametrize("name", ["medicalnet-A-hw", "medicalnet-B-full",
                                  "res2net", "swin", "unetr"])
def test_family_eval_matches_jax(rng, name):
    spec, x, jm, params, stats, tm = _pair(name, rng)
    ref = _eval_apply(name, params, stats, x)
    out = tm.eval()(T(x))
    if isinstance(ref, tuple):  # Swin: (tokens, pooled)
        _close(out[0], ref[0])
    _close(_pooled(out), _pooled(ref))


@pytest.mark.parametrize("name", ["medicalnet-B-hw", "res2net"])
def test_family_train_statistics_match_jax(rng, name):
    spec, x, jm, params, stats, tm = _pair(name, rng)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        ref, mutated = _apply(jm.clone(dtype=jnp.float64), f64(params),
                              f64(stats), f64(x), train=True)
        ref = np.asarray(ref)
        mutated = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    tm = tm.double().train()
    # both modules cast their output to float32 last
    _close(tm(T(x).double()), ref, rel=1e-6)
    want = backbone_state_dict_from_jax(spec, params, mutated)
    got = tm.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(isinstance(m, FlaxBatchNorm3d)
                                for m in tm.modules())
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("spec,shape,width", [
    ("resnet3d-10", (16, 16, 16), 512),
    ("resnet3d-50", (16, 16, 16), 2048),
    ("medicalnet-10", (96, 96, 96), 6144),
    ("medicalnet-10", (128, 128, 128), 8192),
    ("medicalnet-10", (16, 16, 16), 1024),
    ("medicalnet-50", (16, 16, 16), 4096),
    ("res2net50_v1b_26w_4s", (64, 64), 2048),
    ("swin_base_384", (384, 384), 1024),
    ("unetr_vit", (96, 96, 96), 768),
])
def test_registry_widths(spec, shape, width):
    assert registry.feature_width(spec, shape) == width


def test_registry_names_and_refusals():
    """The conv families have a folded serving layout; the LayerNorm ones
    have nothing to fold."""
    for spec, shape, foldable in (("resnet3d-10", (16, 16, 16), True),
                                  ("medicalnet-10", (16, 16, 16), True),
                                  ("res2net50_v1b_26w_4s", (64, 64), True),
                                  ("swin_base_384", (384, 384), False),
                                  ("unetr_vit", (16, 16, 16), False)):
        with torch.device("meta"):
            model = registry.build_backbone(spec, shape)
        assert isinstance(model, FoldableBackbone) == foldable, spec
    with pytest.raises(ValueError, match="2D images"):
        registry.build_backbone("swin_base_384", (16, 16, 16))
    with pytest.raises(ValueError, match="2D images"):
        registry.build_backbone("res2net50_v1b_26w_4s", (16, 16, 16))
    with pytest.raises(ValueError, match="3D volumes"):
        registry.build_backbone("unetr_vit", (96, 96))
    with pytest.raises(ValueError, match="patch size"):
        registry.build_backbone("unetr_vit", (20, 20, 20))
    with pytest.raises(ValueError, match="unknown backbone"):
        registry.build_backbone("vgg16", (16, 16, 16))
    with pytest.raises(ValueError, match="depth"):
        registry.build_backbone("medicalnet-11", (16, 16, 16))


def test_unetr_vit_one_token_matches_jax(rng):
    """The registry's full unetr_vit (hidden 768, 12 layers, 12 heads) at
    16^3: one token."""
    from otfusion_tpu.models.registry import build_backbone as jax_build

    with torch.device("meta"):  # 85M parameters: skip their init
        tm = registry.build_backbone("unetr_vit", (16, 16, 16))
    params, _ = unetr_vit_tree_from_torch({
        k: 0.05 * rng.standard_normal(v.shape, dtype=np.float32)
        for k, v in tm.state_dict().items()})
    assert params["pos_embed"].shape == (1, 1, 768)
    tm.load_state_dict(backbone_state_dict_from_jax("unetr_vit", params),
                       assign=True)
    x = rng.normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    _close(tm.eval()(T(x)), _apply(jax_build("unetr_vit"), params, {}, x))


@pytest.mark.parametrize("name", ["medicalnet-B-hw", "medicalnet-A-hw",
                                  "res2net"])
def test_zoo_fold_matches_unfolded_and_jax(rng, name):
    spec, x, jm, params, stats, tm = _pair(name, rng)
    want = tm.eval()(T(x)).detach()
    folded = fold_zoo_conv_bn(tm.state_dict(), tm)
    assert not any("running" in k for k in folded)
    tm.fold_bn_().load_state_dict(folded)
    _close(tm(T(x)), want)
    for key, value in backbone_state_dict_from_jax(
            spec, jax_fold_zoo(params, stats)).items():
        np.testing.assert_allclose(folded[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="inference-only"):
        tm.train()(T(x))


def test_zoo_fold_refuses_a_batchnorm_without_conv():
    tm = MedicalNetResNet(10, input_depth=16)
    tm.layer1[0].extra = FlaxBatchNorm3d(64)
    with pytest.raises(ValueError, match="no conv partner"):
        fold_zoo_conv_bn(tm.state_dict(), tm)


# name -> (family of FAMILIES with the generator's geometry, generator)
GRAFTS = {
    "medicalnet": ("medicalnet-B-full", _medicalnet10_sd),
    "res2net": ("res2net", _res2net_sd),
    "swin": ("swin", functools.partial(_tiny_swin_sd, embed=16)),
    "unetr": ("unetr", functools.partial(_unetr_sd, hidden=64, heads=4,
                                         blocks=2, patch=8, n_tokens=12)),
}


@pytest.mark.parametrize("name", list(GRAFTS))
def test_pth_graft_matches_jax_graft(rng, tmp_path, name, capsys):
    """The same synthetic official-layout ``.pth`` grafted onto the same
    initial weights by the JAX package and by the port: the same forward,
    and every tensor the JAX converter reads from the file lands in both."""
    family, make_sd = GRAFTS[name]
    spec, _, tm, shape, importer = FAMILIES[family]()
    torch.manual_seed(0)
    params, stats = importer(_numpy_sd(tm))
    sd = make_sd(rng)
    pth = tmp_path / "weights.pth"
    torch.save({"state_dict": {"module." + k: T(np.asarray(v))
                               for k, v in sd.items()}}, pth)
    holder = nn.Module()
    holder.backbone = tm
    n = graft_torch_backbone(holder, pth, "backbone", backbone=spec)
    assert "skipped 0" in capsys.readouterr().out

    src_p, src_s = importer(sd)
    loaded, skipped = [], []
    _graft(params, src_p, (), loaded, skipped)
    _graft(stats, src_s, (), loaded, skipped)
    # the JAX tree splits UNETR's fused qkv into three leaves
    n_split = (2 * sum(k.endswith("attn.qkv.weight") for k in sd)
               if name == "unetr" else 0)
    assert skipped == [] and n == len(loaded) - n_split
    x = rng.normal(size=shape).astype(np.float32)
    _close(_pooled(tm.eval()(T(x))),
           _pooled(_eval_apply(family, params, stats, x)))


def test_unetr_qkv_bias_starts_at_zero():
    """MONAI's qkv has no bias: after a graft the port's keeps flax's zero
    initialisation, not ``nn.Linear``'s uniform one."""
    tm = UNETRViTEncoder(img_size=(8, 8, 8), hidden=16, layers=2, heads=2,
                         patch_size=4)
    for block in tm.blocks:
        assert torch.count_nonzero(block.attn.qkv.bias) == 0
