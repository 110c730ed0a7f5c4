"""Loss functions (port of ``otfusion_tpu.train.losses``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in fp32."""
    return F.cross_entropy(logits.float(), labels.long())


def cosine_alignment_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``1 - mean(cos_sim(x_i, y_i))`` over rows, in fp32, NaN sent to 0."""
    x = x.float()
    y = y.float()
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                             1e-12)
    yn = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=1, keepdim=True),
                             1e-12)
    loss = 1.0 - torch.mean(torch.sum(xn * yn, dim=1))
    return torch.nan_to_num(loss, nan=0.0)
