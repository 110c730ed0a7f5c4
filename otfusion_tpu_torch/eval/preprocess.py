"""Per-modality VAEs for latent-space OT matching (port of
``otfusion_tpu.eval.preprocess``).

The reference's VAE-then-OT leave-one-out trains one VAE per modality on
the training treatments and solves the OT coupling between their latent
clouds (``harness.run_loo_latent``). These are independent compressors:
no cross-modal alignment is learned here, that is the OT solver's job.
The shared-latent matching method is ``eval.vae``.

``ModalityVAE`` keeps the flax module's layer names (``enc_h1``,
``enc_h2``, ``mu``, ``logvar``, ``dec_h1``, ``dec_h2``, ``out``; hidden
256), so ``utils.convert.modality_vae_state_from_jax`` carries JAX weights
across. Training is full-batch Adam (optax's defaults) on the z-scored
inputs: the MSE reconstruction plus 5e-2 times the standard-normal KL,
both means over all elements; one reparameterisation draw per step. The
trainer is split into ``init_modality_vae`` (flax's initialisation from a
generator seeded by ``seed``), ``modality_vae_step`` (one step on given
normals), ``modality_vae_steps`` (the loop, its normals drawn on the device
from a generator seeded by ``seed + 1``; the per-step losses stay on the
device, no host read) and ``train_modality_vae`` (all three).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.eval.predictors import _zstats, flax_dense_init_
from otfusion_tpu_torch.utils.device import resolve_device

# Parity with scvi-tools' obsm key (the reference's cv.py imports it).
SCVI_LATENT_KEY = "X_scVI"

HIDDEN = 256
KL_WEIGHT = 5e-2
LOGVAR_CLIP = 8.0


def kl_standard_normal(mu: torch.Tensor, logvar: torch.Tensor):
    """0.5 * mean(exp(logvar) + mu^2 - 1 - logvar), over all elements."""
    return 0.5 * torch.mean(torch.exp(logvar) + mu ** 2 - 1.0 - logvar)


class ModalityVAE(nn.Module):
    """One modality's VAE: a Gaussian encoder (``mu`` and ``logvar``
    clipped to +-8) and an MLP decoder, with the training set's z-score
    statistics (``mean``, ``std``: float64 numpy) beside it."""

    def __init__(self, dim: int, latent_dim: int, mean: np.ndarray,
                 std: np.ndarray):
        super().__init__()
        self.dim, self.latent_dim = dim, latent_dim
        self.mean, self.std = mean, std
        self.enc_h1 = nn.Linear(dim, HIDDEN)
        self.enc_h2 = nn.Linear(HIDDEN, HIDDEN)
        self.mu = nn.Linear(HIDDEN, latent_dim)
        self.logvar = nn.Linear(HIDDEN, latent_dim)
        self.dec_h1 = nn.Linear(latent_dim, HIDDEN)
        self.dec_h2 = nn.Linear(HIDDEN, HIDDEN)
        self.out = nn.Linear(HIDDEN, dim)

    def encode(self, x: torch.Tensor):
        h = F.relu(self.enc_h1(x))
        h = F.relu(self.enc_h2(h))
        return self.mu(h), torch.clamp(self.logvar(h), -LOGVAR_CLIP,
                                       LOGVAR_CLIP)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.dec_h1(z))
        h = F.relu(self.dec_h2(h))
        return self.out(h)

    def loss(self, xn: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(total, recon, kl) as one (3,) tensor, its first entry
        differentiable, for the normals ``noise`` of the draw."""
        mu, lv = self.encode(xn)
        z = mu + torch.exp(0.5 * lv) * noise
        recon = torch.mean((self.decode(z) - xn) ** 2)
        kl = kl_standard_normal(mu, lv)
        return torch.stack([recon + KL_WEIGHT * kl, recon, kl])


def _normed(a: np.ndarray, mean: np.ndarray, std: np.ndarray,
            device) -> torch.Tensor:
    return torch.as_tensor(
        ((np.asarray(a, np.float64) - mean) / std).astype(np.float32),
        device=device)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def init_modality_vae(x_dict: Dict, latent_dim: int = 10, *, seed: int = 0,
                      device="cuda") -> Tuple[ModalityVAE, torch.Tensor]:
    """The untrained VAE of ``x_dict``'s modality (flax's initialisation
    from a generator seeded by ``seed``) on ``device``, and the z-scored
    inputs (labels in sorted order) as a float32 device tensor."""
    device = resolve_device(device)
    x = np.concatenate(
        [np.asarray(x_dict[k], np.float64) for k in sorted(x_dict)])
    mean, std = _zstats(x)
    model = ModalityVAE(x.shape[1], latent_dim, mean, std)
    flax_dense_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device), _normed(x, mean, std, device)


def modality_vae_step(model: ModalityVAE, opt: torch.optim.Optimizer,
                      xn: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """One Adam step on the normals ``noise`` (shape of the latents);
    returns the step's (total, recon, kl) losses, detached, on the
    device."""
    losses = model.loss(xn, noise)
    opt.zero_grad(set_to_none=True)
    losses[0].backward()
    opt.step()
    return losses.detach()


def modality_vae_steps(model: ModalityVAE, opt: torch.optim.Optimizer,
                       xn: torch.Tensor, steps: int,
                       seed: int) -> torch.Tensor:
    """``steps`` steps on normals from a generator on ``xn``'s device
    seeded by ``seed + 1``; returns the (steps, 3) losses on the device,
    unread."""
    gen = torch.Generator(device=xn.device).manual_seed(seed + 1)
    trace = torch.empty((steps, 3), device=xn.device)
    for s in range(steps):
        noise = torch.randn((xn.shape[0], model.latent_dim), generator=gen,
                            device=xn.device)
        trace[s] = modality_vae_step(model, opt, xn, noise)
    return trace


def make_adam(params, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_modality_vae(
    x_dict: Dict,
    latent_dim: int = 10,
    *,
    steps: int = 500,
    lr: float = 1e-3,
    seed: int = 0,
    device="cuda",
) -> Tuple[ModalityVAE, Dict]:
    """Train one VAE on every sample of one modality; ``x_dict`` is the
    harness's {treatment label: (n_l, d)} layout. Returns ``(model,
    log)``: ``log["final_loss"]`` and ``log["losses"]`` (every
    ``max(1, steps // 50)``-th step's total loss)."""
    model, xn = init_modality_vae(x_dict, latent_dim, seed=seed,
                                  device=device)
    opt = make_adam(model.parameters(), lr)
    trace = modality_vae_steps(model, opt, xn, steps, seed)
    losses = trace[:, 0].cpu().numpy()
    model.eval()
    return model, {
        "final_loss": float(losses[-1]),
        "losses": losses[:: max(1, steps // 50)].tolist(),
    }


def encode(model: ModalityVAE, x: np.ndarray) -> np.ndarray:
    """Posterior-mean latent coordinates (the SCVI_LATENT_KEY obsm), as
    float64 numpy."""
    with torch.no_grad():
        mu, _ = model.encode(_normed(x, model.mean, model.std,
                                     _device_of(model)))
    return mu.cpu().numpy().astype(np.float64)


def decode(model: ModalityVAE, z: np.ndarray) -> np.ndarray:
    """Latent -> data space, un-normalised to the input scale (float64)."""
    zt = torch.as_tensor(np.asarray(z, np.float32), device=_device_of(model))
    with torch.no_grad():
        out = model.decode(zt)
    return out.cpu().numpy().astype(np.float64) * model.std + model.mean


def encode_dict(model: ModalityVAE, x_dict: Dict) -> Dict:
    """Encode every treatment group ({label: (n_l, d)} -> latents)."""
    return {k: encode(model, np.asarray(v)) for k, v in x_dict.items()}


__all__ = [
    "SCVI_LATENT_KEY",
    "ModalityVAE",
    "decode",
    "encode",
    "encode_dict",
    "init_modality_vae",
    "modality_vae_step",
    "modality_vae_steps",
    "train_modality_vae",
]
