"""Weights from the JAX package's parameter trees into the port's modules.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` / ``flax.core.unfreeze`` output). Output:
a ``state_dict`` of the port's ``MultimodalOTFusion``, ``ResNet3DClassifier``
or ``ResNet3DBackbone``. Layouts:

  Conv kernel    (kD, kH, kW, I, O)        -> (O, I, kD, kH, kW)
  Dense kernel   (in, out)                 -> (out, in)
  MHA q/k/v      (embed, heads, head_dim)  -> (heads*head_dim, embed)
  MHA out        (heads, head_dim, embed)  -> (embed, heads*head_dim)
  BatchNorm      scale/bias/mean/var       -> weight/bias/running_mean/_var
  LayerNorm      scale/bias                -> weight/bias

A BatchNorm-folded ResNet3D tree (``fold_conv_bn_params``: biased convs, no
BatchNorm) maps onto the port's folded layout (``ResNet3DBackbone.fold_bn_``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from otfusion_tpu_torch.models.resnet3d import DEPTH_CONFIGS


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(tree) -> torch.Tensor:
    return _t(np.transpose(np.asarray(tree["kernel"]), (4, 3, 0, 1, 2)))


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


def fusion_state_dict_from_jax(params: Dict[str, Any],
                               batch_stats: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``MultimodalOTFusion`` from the JAX
    ``MultimodalOTFusion`` params and batch_stats trees."""
    out: Dict[str, torch.Tensor] = {}
    for side in ("mri_backbone", "pet_backbone"):
        out.update(resnet3d_state_dict_from_jax(
            params[side], (batch_stats or {}).get(side), prefix=side))
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
