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
    """State dict of ``ResNet3DBackbone`` from the JAX backbone subtrees."""
    depth = _depth_of(params)
    layers, kind = DEPTH_CONFIGS[depth]
    block_cls = "BasicBlock3D" if kind == "basic" else "Bottleneck3D"
    n_convs = 2 if kind == "basic" else 3
    out: Dict[str, torch.Tensor] = {}
    p = prefix + "." if prefix else ""
    out[f"{p}conv1.weight"] = _conv(params["_ConvBN_0"]["Conv_0"])
    _bn(out, f"{p}bn1", params["_ConvBN_0"]["BatchNorm_0"],
        batch_stats["_ConvBN_0"]["BatchNorm_0"])
    g = 0
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            bp = params[f"{block_cls}_{g}"]
            bs = batch_stats[f"{block_cls}_{g}"]
            t = f"{p}layer{stage + 1}.{i}"
            for c in range(n_convs):
                out[f"{t}.conv{c + 1}.weight"] = _conv(bp[f"_ConvBN_{c}"]["Conv_0"])
                _bn(out, f"{t}.bn{c + 1}", bp[f"_ConvBN_{c}"]["BatchNorm_0"],
                    bs[f"_ConvBN_{c}"]["BatchNorm_0"])
            ds = f"_ConvBN_{n_convs}"
            if ds in bp:
                out[f"{t}.downsample.0.weight"] = _conv(bp[ds]["Conv_0"])
                _bn(out, f"{t}.downsample.1", bp[ds]["BatchNorm_0"],
                    bs[ds]["BatchNorm_0"])
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
            params[side], batch_stats[side], prefix=side))
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
                                       batch_stats["backbone"],
                                       prefix="backbone")
    _dense(out, "fc", params["fc"])
    return out
