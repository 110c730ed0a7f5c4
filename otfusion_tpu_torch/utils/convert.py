"""Weights from the JAX package's parameter trees into the port's modules.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` / ``flax.core.unfreeze`` output). Output:
a ``state_dict`` of the port's ``MultimodalOTFusion`` (any pair of
backbones), ``ResNet3DClassifier``, of one zoo backbone
(``backbone_state_dict_from_jax``: ResNet3D, MedicalNet, Res2Net, Swin,
UNETR), or of the eval harness's MLP (``mlp_state_dict_from_jax``).
Layouts:

  Conv kernel    (kD, kH, kW, I, O)        -> (O, I, kD, kH, kW) (2D alike)
  Dense kernel   (in, out)                 -> (out, in)
  MHA q/k/v      (embed, heads, head_dim)  -> (heads*head_dim, embed)
  MHA out        (heads, head_dim, embed)  -> (embed, heads*head_dim)
  BatchNorm      scale/bias/mean/var       -> weight/bias/running_mean/_var
  LayerNorm      scale/bias                -> weight/bias

UNETR's three q/k/v projections stack into the fused ``attn.qkv``
([q|k|v][heads][head_dim], MONAI's order). Swin's patch-merging LayerNorm
and reduction permute their four C-wide blocks from the JAX quadrant order
(0,0), (0,1), (1,0), (1,1) to the port's official one (0,0), (1,0), (0,1),
(1,1). A BatchNorm-folded tree (``fold_conv_bn_params`` /
``fold_zoo_conv_bn``: biased convs, no BatchNorm) maps onto the port's
folded layout (``fold_bn_()``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from otfusion_tpu_torch.models.res2net import SCALE
from otfusion_tpu_torch.models.resnet3d import DEPTH_CONFIGS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(tree) -> torch.Tensor:
    k = np.asarray(tree["kernel"])
    return _t(np.transpose(k, (k.ndim - 1, k.ndim - 2,
                               *range(k.ndim - 2))))


def _conv_into(out, name, tree) -> None:
    """A conv kernel (and the bias a folded conv has)."""
    out[f"{name}.weight"] = _conv(tree)
    if "bias" in tree:
        out[f"{name}.bias"] = _t(tree["bias"])


def _conv_bn(out, conv, bn, params, stats) -> None:
    """A flax ``_ConvBN`` subtree: the conv and its BatchNorm, or the
    folded conv's bias."""
    out[f"{conv}.weight"] = _conv(params["Conv_0"])
    if "BatchNorm_0" in params:
        _bn(out, bn, params["BatchNorm_0"], stats["BatchNorm_0"])
    else:
        out[f"{conv}.bias"] = _t(params["Conv_0"]["bias"])


def _bn(out, prefix, params, stats) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _dense(out, prefix, tree) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _depth_of(params) -> int:
    blocks = [k for k in params if k.startswith(("BasicBlock3D_",
                                                 "Bottleneck3D_"))]
    kind = "basic" if blocks[0].startswith("Basic") else "bottleneck"
    for depth, (layers, k) in DEPTH_CONFIGS.items():
        if k == kind and sum(layers) == len(blocks):
            return depth
    raise ValueError(f"no ResNet3D depth has {len(blocks)} {kind} blocks")


def resnet3d_state_dict_from_jax(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any],
                                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """State dict of ``ResNet3DBackbone`` from the JAX backbone subtrees
    (``batch_stats`` may be empty for a folded tree)."""
    depth = _depth_of(params)
    layers, kind = DEPTH_CONFIGS[depth]
    block_cls = "BasicBlock3D" if kind == "basic" else "Bottleneck3D"
    n_convs = 2 if kind == "basic" else 3
    out: Dict[str, torch.Tensor] = {}
    p = prefix + "." if prefix else ""
    stats = batch_stats or {}
    _conv_bn(out, f"{p}conv1", f"{p}bn1", params["_ConvBN_0"],
             stats.get("_ConvBN_0"))
    g = 0
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            bp = params[f"{block_cls}_{g}"]
            bs = stats.get(f"{block_cls}_{g}", {})
            t = f"{p}layer{stage + 1}.{i}"
            for c in range(n_convs):
                _conv_bn(out, f"{t}.conv{c + 1}", f"{t}.bn{c + 1}",
                         bp[f"_ConvBN_{c}"], bs.get(f"_ConvBN_{c}"))
            ds = f"_ConvBN_{n_convs}"
            if ds in bp:
                _conv_bn(out, f"{t}.downsample.0", f"{t}.downsample.1",
                         bp[ds], bs.get(ds))
            g += 1
    return out


def _mha(out, prefix, tree) -> None:
    for name in ("query", "key", "value"):
        k = np.asarray(tree[name]["kernel"])
        e = k.shape[0]
        out[f"{prefix}.{name}.weight"] = _t(k.reshape(e, -1).T)
        out[f"{prefix}.{name}.bias"] = _t(np.asarray(tree[name]["bias"]).reshape(-1))
    k = np.asarray(tree["out"]["kernel"])
    out[f"{prefix}.out.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
    out[f"{prefix}.out.bias"] = _t(tree["out"]["bias"])


def _layer_norm(out, prefix, tree) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def _bn_if(out, prefix, params, stats, name) -> None:
    if name in params:
        _bn(out, prefix, params[name], stats[name])


def medicalnet_state_dict_from_jax(params, batch_stats, prefix=""
                                   ) -> Dict[str, torch.Tensor]:
    """State dict of ``MedicalNetResNet`` from the JAX ``MedicalNetResNet``
    subtrees (folded or not). In a JAX block the 3x3 convs sit in
    ``_Conv3_i`` submodules and the BatchNorms are block-level siblings,
    numbered in call order."""
    p = prefix + "." if prefix else ""
    stats = batch_stats or {}
    out: Dict[str, torch.Tensor] = {}
    _conv_into(out, f"{p}conv1", params["Conv_0"])
    _bn_if(out, f"{p}bn1", params, stats, "BatchNorm_0")
    blocks = sorted((k for k in params if k.startswith("Medical")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    basic = blocks[0].startswith("MedicalBasicBlock")
    for depth, (layers, kind) in DEPTH_CONFIGS.items():
        if (kind == "basic") == basic and sum(layers) == len(blocks):
            break
    else:
        raise ValueError(f"no MedicalNet depth has {len(blocks)} blocks")
    if basic:
        convs = (("conv1", ("_Conv3_0", "Conv_0"), "BatchNorm_0"),
                 ("conv2", ("_Conv3_1", "Conv_0"), "BatchNorm_1"),
                 ("downsample.0", ("Conv_0",), "BatchNorm_2"))
    else:
        convs = (("conv1", ("Conv_0",), "BatchNorm_0"),
                 ("conv2", ("_Conv3_0", "Conv_0"), "BatchNorm_1"),
                 ("conv3", ("Conv_1",), "BatchNorm_2"),
                 ("downsample.0", ("Conv_2",), "BatchNorm_3"))
    g = 0
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            bp = params[blocks[g]]
            bs = stats.get(blocks[g], {})
            t = f"{p}layer{stage + 1}.{i}"
            for name, path, bn in convs:
                node = bp
                for step in path:
                    node = node.get(step) if isinstance(node, dict) else None
                if node is None:
                    continue  # no type-B shortcut in this block
                _conv_into(out, f"{t}.{name}", node)
                bn_name = (f"{t}.downsample.1" if name == "downsample.0"
                           else f"{t}.bn{name[-1]}")
                _bn_if(out, bn_name, bp, bs, bn)
            g += 1
    return out


def res2net_state_dict_from_jax(params, batch_stats, prefix=""
                                ) -> Dict[str, torch.Tensor]:
    """State dict of ``Res2Net`` from the JAX ``Res2Net`` subtrees (folded
    or not). A stage starts at each block with a downsample conv."""
    p = prefix + "." if prefix else ""
    stats = batch_stats or {}
    out: Dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate((("conv1.0", "conv1.1"),
                                    ("conv1.3", "conv1.4"),
                                    ("conv1.6", "bn1"))):
        _conv_into(out, f"{p}{conv}", params[f"Conv_{i}"])
        _bn_if(out, f"{p}{bn}", params, stats, f"BatchNorm_{i}")
    n_mid = SCALE - 1
    names = (["conv1"] + [f"convs.{j}" for j in range(n_mid)]
             + ["conv3", "downsample.1"])
    bns = (["bn1"] + [f"bns.{j}" for j in range(n_mid)]
           + ["bn3", "downsample.2"])
    blocks = sorted((k for k in params if k.startswith("Bottle2neck_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    stage, i = -1, 0
    for name in blocks:
        bp, bs = params[name], stats.get(name, {})
        if f"Conv_{n_mid + 2}" in bp:
            stage, i = stage + 1, 0
        t = f"{p}layer{stage + 1}.{i}"
        for k, (conv, bn) in enumerate(zip(names, bns)):
            if f"Conv_{k}" in bp:
                _conv_into(out, f"{t}.{conv}", bp[f"Conv_{k}"])
                _bn_if(out, f"{t}.{bn}", bp, bs, f"BatchNorm_{k}")
        i += 1
    return out


def _merge_quadrant_perm(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Swap the 2nd and 3rd of the four equal blocks along ``axis``: the
    JAX patch merging's quadrant order <-> the official one (the swap is
    its own inverse)."""
    c = x.shape[axis] // 4
    idx = np.concatenate([np.arange(0, c), np.arange(2 * c, 3 * c),
                          np.arange(c, 2 * c), np.arange(3 * c, 4 * c)])
    return np.take(x, idx, axis=axis)


def swin_state_dict_from_jax(params, prefix="") -> Dict[str, torch.Tensor]:
    """State dict of ``SwinTransformer2D`` from the JAX tree."""
    p = prefix + "." if prefix else ""
    out: Dict[str, torch.Tensor] = {}
    _conv_into(out, f"{p}patch_embed.proj", params["patch_embed"])
    _layer_norm(out, f"{p}patch_embed.norm", params["LayerNorm_0"])
    for name, sub in params.items():
        if name.startswith("stage"):
            stage, block = name[len("stage"):].split("_block")
            t = f"{p}layers.{stage}.blocks.{block}"
            _layer_norm(out, f"{t}.norm1", sub["LayerNorm_0"])
            _layer_norm(out, f"{t}.norm2", sub["LayerNorm_1"])
            att = sub["WindowAttention_0"]
            _dense(out, f"{t}.attn.qkv", att["qkv"])
            _dense(out, f"{t}.attn.proj", att["proj"])
            out[f"{t}.attn.relative_position_bias_table"] = _t(
                att["relative_position_bias_table"])
            _dense(out, f"{t}.mlp.fc1", sub["Dense_0"])
            _dense(out, f"{t}.mlp.fc2", sub["Dense_1"])
        elif name.startswith("merge"):
            t = f"{p}layers.{name[len('merge'):]}.downsample"
            ln = sub["LayerNorm_0"]
            out[f"{t}.norm.weight"] = _t(_merge_quadrant_perm(
                np.asarray(ln["scale"])))
            out[f"{t}.norm.bias"] = _t(_merge_quadrant_perm(
                np.asarray(ln["bias"])))
            out[f"{t}.reduction.weight"] = _t(_merge_quadrant_perm(
                np.asarray(sub["Dense_0"]["kernel"]), axis=0).T)
    _layer_norm(out, f"{p}norm", params["norm"])
    return out


def unetr_state_dict_from_jax(params, prefix="") -> Dict[str, torch.Tensor]:
    """State dict of ``UNETRViTEncoder`` from the JAX tree: the flax MHA's
    q/k/v stack into the fused ``qkv``."""
    p = prefix + "." if prefix else ""
    out: Dict[str, torch.Tensor] = {}
    _dense(out, f"{p}patch_embedding.patch_embeddings", params["patch_embed"])
    out[f"{p}patch_embedding.position_embeddings"] = _t(params["pos_embed"])
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        t = f"{p}blocks.{i}"
        _layer_norm(out, f"{t}.norm1", blk["LayerNorm_0"])
        _layer_norm(out, f"{t}.norm2", blk["LayerNorm_1"])
        att = blk["MultiHeadDotProductAttention_0"]
        ws = [np.asarray(att[n]["kernel"]) for n in ("query", "key", "value")]
        h = ws[0].shape[0]
        out[f"{t}.attn.qkv.weight"] = _t(np.concatenate(
            [w.reshape(h, -1).T for w in ws]))
        out[f"{t}.attn.qkv.bias"] = _t(np.concatenate(
            [np.asarray(att[n]["bias"]).reshape(-1)
             for n in ("query", "key", "value")]))
        k = np.asarray(att["out"]["kernel"])
        out[f"{t}.attn.out_proj.weight"] = _t(k.reshape(-1, k.shape[-1]).T)
        out[f"{t}.attn.out_proj.bias"] = _t(att["out"]["bias"])
        _dense(out, f"{t}.mlp.linear1", blk["Dense_0"])
        _dense(out, f"{t}.mlp.linear2", blk["Dense_1"])
        i += 1
    _layer_norm(out, f"{p}norm", params["LayerNorm_0"])
    return out


def backbone_state_dict_from_jax(spec: str, params, batch_stats=None,
                                 prefix: str = ""
                                 ) -> Dict[str, torch.Tensor]:
    """State dict of the port's backbone for registry ``spec`` ('' = the
    inline ResNet3D) from its JAX subtrees."""
    spec = (spec or "").lower()
    if spec == "" or spec.startswith("resnet3d"):
        return resnet3d_state_dict_from_jax(params, batch_stats, prefix)
    if spec.startswith("medicalnet-"):
        return medicalnet_state_dict_from_jax(params, batch_stats, prefix)
    if spec.startswith("res2net"):
        return res2net_state_dict_from_jax(params, batch_stats, prefix)
    if spec.startswith("swin"):
        return swin_state_dict_from_jax(params, prefix)
    if spec.startswith("unetr"):
        return unetr_state_dict_from_jax(params, prefix)
    raise ValueError(f"unknown backbone: {spec}")


def fusion_state_dict_from_jax(params: Dict[str, Any],
                               batch_stats: Dict[str, Any],
                               mri_backbone: str = "",
                               pet_backbone: str = ""
                               ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``MultimodalOTFusion`` from the JAX
    ``MultimodalOTFusion`` params and batch_stats trees, its backbones the
    registry specs ``mri_backbone`` / ``pet_backbone``."""
    out: Dict[str, torch.Tensor] = {}
    for side, spec in (("mri_backbone", mri_backbone),
                       ("pet_backbone", pet_backbone)):
        out.update(backbone_state_dict_from_jax(
            spec, params[side], (batch_stats or {}).get(side), prefix=side))
    for name in ("mri2pet", "pet2mri", "mri_fusion", "pet_fusion"):
        _dense(out, f"{name}.dense0", params[name]["Dense_0"])
        _dense(out, f"{name}.dense1", params[name]["Dense_1"])
    att = params["attention_mri"]
    _mha(out, "attention_mri.attn", att["MultiHeadDotProductAttention_0"])
    _layer_norm(out, "attention_mri.norm1", att["LayerNorm_0"])
    _dense(out, "attention_mri.ff1", att["Dense_0"])
    _dense(out, "attention_mri.ff2", att["Dense_1"])
    _layer_norm(out, "attention_mri.norm2", att["LayerNorm_1"])
    _dense(out, "fc", params["fc"])
    return out


def classifier_state_dict_from_jax(params: Dict[str, Any],
                                   batch_stats: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``ResNet3DClassifier`` from the JAX
    ``ResNet3DClassifier`` params and batch_stats trees."""
    out = resnet3d_state_dict_from_jax(params["backbone"],
                                       (batch_stats or {}).get("backbone"),
                                       prefix="backbone")
    _dense(out, "fc", params["fc"])
    return out


def mlp_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the harness's ``eval.predictors.MLP`` from the flax
    params of the JAX package's ``train_mlp`` MLP (``Dense_0`` to
    ``Dense_2``)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(3):
        _dense(out, f"dense{i}", params[f"Dense_{i}"])
    return out
