"""Optimiser and LR schedule (port of ``otfusion_tpu.train.train_state``).

AdamW as optax's ``adamw`` with the fusion trainers' settings: weight decay
1e-5 (not torch's default 1e-2), betas (0.9, 0.999), eps 1e-8, on every
parameter; ``kind="adam"`` is optax's ``adam`` with the same betas and eps
and no weight decay (the unimodal trainer). The plateau scheduler is the
same epoch-level state machine as the JAX package's, feeding
``set_learning_rate``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 1e-5,
                   kind: str = "adamw") -> torch.optim.Optimizer:
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if kind == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    raise ValueError(f"unknown optimizer kind: {kind}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Overwrite the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class ReduceLROnPlateau:
    """Epoch-level plateau scheduler: mode 'min', factor 0.5, patience 5,
    relative improvement threshold 1e-4."""

    initial_lr: float
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 0.0
    threshold: float = 1e-4

    def __post_init__(self):
        self.lr = self.initial_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        """Feed the epoch's validation loss; returns the learning rate to
        use next epoch."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
