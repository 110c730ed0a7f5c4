"""Backbone registry (port of ``otfusion_tpu.models.registry``).

``build_backbone(spec, input_shape)`` maps a registry name onto the zoo:

  resnet3d-{10,18,34,50,101,152,200}   inline 3D ResNet (plain stem)
  medicalnet-{10,...,200}              dilated MedicalNet trunk, pool "hw"
  res2net50_v1b_26w_4s                 2D multi-scale encoder (2048-d)
  swin_base_384                        2D Swin, returns (tokens, pooled)
  unetr_vit                            3D ViT encoder (768-d)

``input_shape`` is the spatial shape of the inputs the backbone will see:
(D, H, W) for a volume, (H, W) for an image. Widths and some parameter
shapes depend on it (MedicalNet's "hw" pool keeps the depth axis, UNETR's
position embeddings have one row per patch, Swin's windows clamp to small
feature maps), so the port sizes everything at construction where JAX
infers it at the first call. A 2D family given a volume shape raises.
"""

from __future__ import annotations

import torch

from otfusion_tpu_torch.models.medicalnet import MedicalNetResNet
from otfusion_tpu_torch.models.res2net import res2net50_v1b_26w_4s
from otfusion_tpu_torch.models.resnet3d import DEPTH_CONFIGS, ResNet3DBackbone
from otfusion_tpu_torch.models.swin import swin_base_384
from otfusion_tpu_torch.models.unetr import UNETRViTEncoder

# Families that take (B, H, W, C) images; the others take volumes.
_IMAGE_FAMILIES = ("res2net", "swin")


def _is_image_family(spec: str) -> bool:
    return spec.lower().startswith(_IMAGE_FAMILIES)


def _depth(spec: str) -> int:
    depth = int(spec.split("-")[1])
    if depth not in DEPTH_CONFIGS:
        raise ValueError(f"unsupported depth {depth}")
    return depth


def build_backbone(spec: str, input_shape) -> torch.nn.Module:
    """The registry backbone ``spec`` for inputs of spatial shape
    ``input_shape``."""
    name = spec.lower()
    shape = tuple(int(n) for n in input_shape)
    if _is_image_family(name) and len(shape) != 2:
        raise ValueError(
            f"backbone {spec!r} takes 2D images (B, H, W, C); this input is "
            f"a {len(shape)}D volume of shape {shape}")
    if not _is_image_family(name) and len(shape) != 3:
        raise ValueError(f"backbone {spec!r} takes 3D volumes; got input "
                         f"shape {shape}")
    if name.startswith("resnet3d-"):
        return ResNet3DBackbone(_depth(name))
    if name.startswith("medicalnet-"):
        return MedicalNetResNet(_depth(name), input_depth=shape[0])
    if name == "res2net50_v1b_26w_4s":
        return res2net50_v1b_26w_4s()
    if name == "swin_base_384":
        return swin_base_384(img_size=shape)
    if name == "unetr_vit":
        return UNETRViTEncoder(img_size=shape)
    raise ValueError(f"unknown backbone: {spec}")


def feature_width(spec: str, input_shape) -> int:
    """The pooled feature width of backbone ``spec`` at ``input_shape``
    (built on the meta device: no memory, no initialisation)."""
    with torch.device("meta"):
        return build_backbone(spec, input_shape).out_dim
