"""Pretrained torch ``.pth`` weights into the port's ResNet3D backbones (the
inline-ResNet3D part of ``otfusion_tpu.utils.torch_import``).

The port's ResNet3D keeps the original torch names, so a graft is a
filtered ``load_state_dict(strict=False)``: the keys of the file that the
target backbone has, with matching shapes, load; the rest are reported as
skipped, as the reference's intersect-keys partial load does. Both naming
schemes of the reference are read: the classifier's ``conv1``/``bn1`` and
the backbone's ``stem.0``/``stem.1`` (then the same ``layerN.i.*`` blocks).
A plain 7x7 stem going into a space-to-depth target is rewritten onto it
(``utils.checkpoint.rewrite_stem_params``). The model zoo's importers come
with the zoo.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch
from torch import nn

from otfusion_tpu_torch.utils.checkpoint import rewrite_stem_params

_STEM_RENAMES = {"stem.0.": "conv1.", "stem.1.": "bn1."}


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


def graft_torch_backbone(model: nn.Module, pth_path: str | Path,
                         target_module: str) -> int:
    """Graft the intersecting, shape-matching tensors of a reference
    ``.pth`` ResNet3D into ``model.<target_module>`` in place; prints how
    many loaded and what was skipped, raises when nothing matched, and
    returns the number loaded."""
    if not hasattr(model, target_module):
        raise KeyError(f"{target_module!r} is not a module of the model")
    target = getattr(model, target_module)
    sd = {}
    for name, tensor in load_torch_state_dict(pth_path).items():
        if name.endswith("num_batches_tracked"):
            continue  # a counter, not a weight
        for old, new in _STEM_RENAMES.items():
            if name.startswith(old):
                name = new + name[len(old):]
        sd[name] = tensor
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
            f"backbone (depth {getattr(target, 'depth', '?')})")
    target.load_state_dict(loaded, strict=False)
    return len(loaded)
