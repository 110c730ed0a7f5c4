"""Pretrained torch ``.pth`` weights into the port's backbones (port of
``otfusion_tpu.utils.torch_import``), for every family of the zoo.

The port's backbones keep the official torch names (the reference's
ResNet3D and MedicalNet, official Res2Net-v1b and Swin, MONAI's UNETR ViT),
so a graft is a filtered ``load_state_dict(strict=False)``: the file's keys
are first renamed and selected per family (below), then those the target
backbone has, with matching shapes, load; the rest are reported as skipped,
as the reference's intersect-keys partial load does. It raises when nothing
matched.

Per family, as the JAX converters read the same files:
  * ResNet3D: both naming schemes of the reference, the classifier's
    ``conv1``/``bn1`` and the backbone's ``stem.0``/``stem.1``; a plain 7x7
    stem going into a space-to-depth target is rewritten onto it
    (``utils.checkpoint.rewrite_stem_params``). Every key is a candidate.
  * MedicalNet, Res2Net: the trunk (``conv1``, ``bn1``, ``layerN``); the
    segmentation head ``conv_seg`` / the classifier ``fc`` are not read.
  * Swin: ``patch_embed``, ``layers``, ``norm``; the ``head`` and the
    ``relative_position_index`` / ``attn_mask`` buffers (recomputed) are not
    read.
  * UNETR: a full-UNETR file keeps its encoder under ``vit.`` (the decoder
    is not read); the patch embedding's MONAI name
    ``patch_embeddings.1`` (a Sequential after a Rearrange) is the port's
    ``patch_embeddings``; ``cls_token`` is not read (the encoder pools).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

import torch
from torch import nn

from otfusion_tpu_torch.utils.checkpoint import rewrite_stem_params

_STEM_RENAMES = {"stem.0.": "conv1.", "stem.1.": "bn1."}

# Keys each zoo family reads (after its renames); the rest of a file is
# another model's part (a head, a decoder, a recomputed buffer).
_FAMILY_KEYS = {
    "medicalnet": re.compile(r"(conv1|bn1|layer\d+)\."),
    "res2net": re.compile(r"(conv1|bn1|layer\d+)\."),
    "swin": re.compile(r"(patch_embed\.|norm\.|layers\.(?!.*\.("
                       r"relative_position_index|attn_mask)$))"),
    "unetr": re.compile(r"(patch_embedding\.(patch_embeddings|"
                        r"position_embeddings)|blocks\.|norm\.)"),
}


def load_torch_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """Read a ``.pth``/``.pt`` file into {name: float32 tensor}: unwraps a
    ``model_state_dict``/``state_dict``/``model`` checkpoint dict and strips
    DataParallel's ``module.`` prefix."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    out = {}
    for name, tensor in obj.items():
        if name.startswith("module."):
            name = name[len("module."):]
        if isinstance(tensor, torch.Tensor):
            out[name] = tensor.detach().to(torch.float32)
    return out


def _family(backbone: str) -> str:
    spec = (backbone or "").lower()
    if spec == "" or spec.startswith("resnet3d"):
        return "resnet3d"
    for family in _FAMILY_KEYS:
        if spec.startswith(family):
            return family
    raise ValueError(f"no torch .pth importer for backbone {backbone!r}")


def _select(sd: Dict[str, torch.Tensor], family: str
            ) -> Dict[str, torch.Tensor]:
    """The keys of ``sd`` that ``family`` reads, under the port's names."""
    if family == "resnet3d":
        out = {}
        for name, tensor in sd.items():
            for old, new in _STEM_RENAMES.items():
                if name.startswith(old):
                    name = new + name[len(old):]
            out[name] = tensor
        return out
    if family == "unetr":
        if any(k.startswith("vit.") for k in sd):
            sd = {k[len("vit."):]: v for k, v in sd.items()
                  if k.startswith("vit.")}
        sd = {k.replace("patch_embeddings.1.", "patch_embeddings."): v
              for k, v in sd.items()}
    return {k: v for k, v in sd.items() if _FAMILY_KEYS[family].match(k)}


def graft_torch_backbone(model: nn.Module, pth_path: str | Path,
                         target_module: str, backbone: str = "") -> int:
    """Graft the intersecting, shape-matching tensors of a reference
    ``.pth`` backbone of registry family ``backbone`` ('' = the inline
    ResNet3D) into ``model.<target_module>`` in place; prints how many
    loaded and what was skipped, raises when nothing matched, and returns
    the number loaded."""
    if not hasattr(model, target_module):
        raise KeyError(f"{target_module!r} is not a module of the model")
    target = getattr(model, target_module)
    family = _family(backbone)
    sd = _select({k: v for k, v in load_torch_state_dict(pth_path).items()
                  if not k.endswith("num_batches_tracked")}, family)
    dst = {k: v for k, v in target.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    sd = rewrite_stem_params(sd, dst)
    loaded, skipped = {}, []
    for name, tensor in sd.items():
        where = f"{target_module}.{name}"
        if name not in dst:
            skipped.append(f"{where} (missing in model)")
        elif tuple(tensor.shape) != tuple(dst[name].shape):
            skipped.append(f"{where} (shape {tuple(tensor.shape)} vs "
                           f"{tuple(dst[name].shape)})")
        else:
            loaded[name] = tensor
    print(f"Grafted {len(loaded)} tensors from {pth_path} into "
          f"{target_module}; skipped {len(skipped)}")
    for s in skipped[:10]:
        print(f"  skipped: {s}")
    if not loaded:
        raise ValueError(
            f"no tensors from {pth_path} matched the {target_module} "
            f"backbone ({backbone or 'resnet3d'}, depth "
            f"{getattr(target, 'depth', '?')})")
    target.load_state_dict(loaded, strict=False)
    return len(loaded)
