"""Cross-modal shared-latent VAE matching, the harness's ``VAE`` and
``VAE_label`` methods (port of ``otfusion_tpu.eval.vae``).

One VAE per modality with a shared latent space: ``enc_x``/``dec_x`` and
``enc_y``/``dec_y`` (Gaussian posteriors, MSE reconstruction,
standard-normal KL). A discriminator ``disc`` tells which modality a latent
came from and the encoders learn to fool it (least-squares GAN): the X
latents are labelled 0 and the Y latents 1 in its loss, and the encoders
pull both towards 0.5. ``use_label=True`` (``VAE_label``) gives the
discriminator the treatment label as a one-hot beside the latent, so its
first layer is ``n_labels`` wider. Hyperparameters arrive as the
reference's tuple ``(adv_weight, latent_dim, learning_rate)``.

A step, as the JAX ``lax.scan`` body: one reparameterisation draw (the same
normals in both halves); the discriminator's loss on the draw's latents
with their gradient stopped, and an Adam step of ``disc`` alone; then the
generator's loss ``recon + 5e-2 KL + adv_weight * 1e-2 adv`` through the
updated, frozen discriminator, and an Adam step of the four encoders and
decoders alone. Two Adam optimisers over disjoint parameter sets stand for
optax's ``multi_transform`` with ``set_to_zero``: the gradient that the
generator's loss leaves in ``disc`` is cleared before the next
discriminator step and never reaches its optimiser. The trainer is split
into ``init_vae_match`` (flax's initialisation from a generator seeded by
``seed``), ``vae_match_step`` (one step on given normals),
``vae_match_steps`` (the loop, its normals drawn on the device from a
generator seeded by ``seed + 1``; the per-step losses stay on the device,
no host read) and ``train_vae_model`` (all three).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from otfusion_tpu_torch.eval.predictors import _zstats, flax_dense_init_
from otfusion_tpu_torch.eval.preprocess import (
    HIDDEN,
    KL_WEIGHT,
    LOGVAR_CLIP,
    _device_of,
    _normed,
    kl_standard_normal,
    make_adam,
)
from otfusion_tpu_torch.utils.device import resolve_device

ADV_SCALE = 1e-2


class Encoder(nn.Module):
    """Two ReLU layers, then the posterior's mean and log-variance (clipped
    to +-8)."""

    def __init__(self, dim: int, latent_dim: int):
        super().__init__()
        self.h1 = nn.Linear(dim, HIDDEN)
        self.h2 = nn.Linear(HIDDEN, HIDDEN)
        self.mu = nn.Linear(HIDDEN, latent_dim)
        self.logvar = nn.Linear(HIDDEN, latent_dim)

    def forward(self, x: torch.Tensor):
        h = F.relu(self.h2(F.relu(self.h1(x))))
        return self.mu(h), torch.clamp(self.logvar(h), -LOGVAR_CLIP,
                                       LOGVAR_CLIP)


class MLPHead(nn.Module):
    """Two ReLU layers and a linear output (decoders, discriminator)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.h1 = nn.Linear(dim, HIDDEN)
        self.h2 = nn.Linear(HIDDEN, HIDDEN)
        self.out = nn.Linear(HIDDEN, out_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(self.h2(F.relu(self.h1(z)))))


class VAEMatchModel(nn.Module):
    """The trained cross-modal VAE (the harness's opaque "model"): the five
    submodules, the widths, the z-score statistics of each modality's
    training features (float64 numpy) and the label count."""

    def __init__(self, dim_x: int, dim_y: int, latent_dim: int,
                 n_labels: int, use_label: bool, stats):
        super().__init__()
        self.dim_x, self.dim_y = dim_x, dim_y
        self.latent_dim, self.n_labels = latent_dim, n_labels
        self.use_label = use_label
        # (x_mean, x_std, y_mean, y_std), float64
        self.x_mean, self.x_std, self.y_mean, self.y_std = stats
        self.enc_x = Encoder(dim_x, latent_dim)
        self.enc_y = Encoder(dim_y, latent_dim)
        self.dec_x = MLPHead(latent_dim, dim_x)
        self.dec_y = MLPHead(latent_dim, dim_y)
        self.disc = MLPHead(latent_dim + (n_labels if use_label else 0), 1)

    def discriminate(self, z: torch.Tensor,
                     onehot: Optional[torch.Tensor]) -> torch.Tensor:
        if onehot is not None:
            z = torch.cat([z, onehot], dim=-1)
        return self.disc(z)[..., 0]

    def generator_parameters(self):
        for name in ("enc_x", "enc_y", "dec_x", "dec_y"):
            yield from getattr(self, name).parameters()


class VAEBatch(NamedTuple):
    """The training set on the device: z-scored features and, for
    ``use_label``, each row's label one-hot (None otherwise)."""

    xn: torch.Tensor
    yn: torch.Tensor
    oh_x: Optional[torch.Tensor]
    oh_y: Optional[torch.Tensor]


def init_vae_match(train_data: Tuple[Dict, Dict], latent_dim: int = 128,
                   use_label: bool = True, *, seed: int = 0,
                   device="cuda") -> Tuple[VAEMatchModel, VAEBatch]:
    """The untrained model (flax's initialisation from a generator seeded by
    ``seed``) on ``device`` and the training batch: labels in sorted order,
    features z-scored in float64 on the host, then float32."""
    device = resolve_device(device)
    x_dict, y_dict = train_data
    labels = sorted(x_dict.keys())
    x = np.concatenate([np.asarray(x_dict[l], np.float64) for l in labels])
    y = np.concatenate([np.asarray(y_dict[l], np.float64) for l in labels])
    x_mean, x_std = _zstats(x)
    y_mean, y_std = _zstats(y)
    model = VAEMatchModel(x.shape[1], y.shape[1], latent_dim, len(labels),
                          use_label, (x_mean, x_std, y_mean, y_std))
    flax_dense_init_(model, torch.Generator().manual_seed(seed))
    model.to(device)

    def onehot(d):
        if not use_label:
            return None
        lab = np.concatenate([np.full(np.asarray(d[l]).shape[0], i)
                              for i, l in enumerate(labels)])
        return F.one_hot(torch.as_tensor(lab, device=device),
                         len(labels)).to(torch.float32)

    batch = VAEBatch(_normed(x, x_mean, x_std, device),
                     _normed(y, y_mean, y_std, device),
                     onehot(x_dict), onehot(y_dict))
    return model, batch


def make_optimizers(model: VAEMatchModel, lr: float):
    """(generator's Adam over the encoders and decoders, discriminator's
    Adam over ``disc``), optax's defaults."""
    return (make_adam(list(model.generator_parameters()), lr),
            make_adam(model.disc.parameters(), lr))


def vae_match_step(model: VAEMatchModel, gen_opt, disc_opt, batch: VAEBatch,
                   noise_x: torch.Tensor, noise_y: torch.Tensor,
                   adv_weight: float) -> torch.Tensor:
    """One step on the normals ``noise_x``/``noise_y`` (shapes of the two
    latents): the discriminator's step, then the generator's. Returns
    (gen loss, disc loss, recon, kl, adv), detached, on the device."""
    mux, lvx = model.enc_x(batch.xn)
    muy, lvy = model.enc_y(batch.yn)
    zx = mux + torch.exp(0.5 * lvx) * noise_x
    zy = muy + torch.exp(0.5 * lvy) * noise_y

    model.zero_grad(set_to_none=True)
    dx = model.discriminate(zx.detach(), batch.oh_x)
    dy = model.discriminate(zy.detach(), batch.oh_y)
    disc_loss = torch.mean(dx ** 2) + torch.mean((dy - 1.0) ** 2)
    disc_loss.backward()
    disc_opt.step()

    # The encoders are unchanged by the discriminator's step, so the draw's
    # latents are the ones the JAX step recomputes.
    model.zero_grad(set_to_none=True)
    recon = (torch.mean((model.dec_x(zx) - batch.xn) ** 2)
             + torch.mean((model.dec_y(zy) - batch.yn) ** 2))
    kl = kl_standard_normal(mux, lvx) + kl_standard_normal(muy, lvy)
    dx = model.discriminate(zx, batch.oh_x)
    dy = model.discriminate(zy, batch.oh_y)
    adv = torch.mean((dx - 0.5) ** 2) + torch.mean((dy - 0.5) ** 2)
    gen_loss = recon + KL_WEIGHT * kl + adv_weight * ADV_SCALE * adv
    gen_loss.backward()
    gen_opt.step()
    return torch.stack([gen_loss, disc_loss, recon, kl, adv]).detach()


def vae_match_steps(model: VAEMatchModel, gen_opt, disc_opt,
                    batch: VAEBatch, steps: int, seed: int,
                    adv_weight: float) -> torch.Tensor:
    """``steps`` steps on normals from a generator on the batch's device
    seeded by ``seed + 1`` (the X draw, then the Y draw, each step);
    returns the (steps, 5) losses on the device, unread."""
    device = batch.xn.device
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    trace = torch.empty((steps, 5), device=device)
    for s in range(steps):
        noise_x = torch.randn((batch.xn.shape[0], model.latent_dim),
                              generator=gen, device=device)
        noise_y = torch.randn((batch.yn.shape[0], model.latent_dim),
                              generator=gen, device=device)
        trace[s] = vae_match_step(model, gen_opt, disc_opt, batch, noise_x,
                                  noise_y, adv_weight)
    return trace


def train_vae_model(
    train_data: Tuple[Dict, Dict],
    eps=(10.0, 128, 1e-4),
    use_label: bool = True,
    *,
    steps: int = 600,
    seed: int = 0,
    device="cuda",
) -> Tuple[VAEMatchModel, Dict]:
    """Train the shared-latent cross-modal VAE. ``eps`` is the reference's
    ``(adv_weight, latent_dim, lr)``. Returns ``(model, log)``, the log
    with the last step's losses (``final_gen_loss``, ``final_disc_loss``,
    ``final_recon``, ``final_kl``, ``final_adv``) and the
    hyperparameters."""
    adv_w, latent_dim, lr = float(eps[0]), int(eps[1]), float(eps[2])
    model, batch = init_vae_match(train_data, latent_dim, use_label,
                                  seed=seed, device=device)
    gen_opt, disc_opt = make_optimizers(model, lr)
    trace = vae_match_steps(model, gen_opt, disc_opt, batch, steps, seed,
                            adv_w)
    gl, dl, recon, kl, adv = trace[-1].cpu().tolist()
    model.eval()
    log = {
        "final_gen_loss": gl,
        "final_disc_loss": dl,
        "final_recon": recon,
        "final_kl": kl,
        "final_adv": adv,
        "adv_weight": adv_w,
        "latent_dim": latent_dim,
        "lr": lr,
        "use_label": use_label,
    }
    return model, log


def _encode(model: VAEMatchModel, a: np.ndarray, which: str) -> np.ndarray:
    mean, std = ((model.x_mean, model.x_std) if which == "enc_x"
                 else (model.y_mean, model.y_std))
    with torch.no_grad():
        mu, _ = getattr(model, which)(_normed(a, mean, std,
                                              _device_of(model)))
    return mu.cpu().numpy().astype(np.float64)


def infer_from_Xs(x_dict: Dict, model: VAEMatchModel, dim_y: int) -> Dict:
    """Each source group's posterior means in the shared latent."""
    return {l: _encode(model, v, "enc_x") for l, v in x_dict.items()}


def infer_from_Ys(y_dict: Dict, model: VAEMatchModel, dim_x: int) -> Dict:
    """Each target group's posterior means in the shared latent."""
    return {l: _encode(model, v, "enc_y") for l, v in y_dict.items()}


def predict_from_model(test_x: np.ndarray, model: VAEMatchModel,
                       dim_y: int) -> np.ndarray:
    """X -> Y through the shared latent: ``enc_x``'s posterior mean decoded
    by ``dec_y``, un-normalised with Y's statistics (float64)."""
    xn = _normed(test_x, model.x_mean, model.x_std, _device_of(model))
    with torch.no_grad():
        mu, _ = model.enc_x(xn)
        yn = model.dec_y(mu)
    return yn.cpu().numpy().astype(np.float64) * model.y_std + model.y_mean


__all__ = [
    "VAEMatchModel",
    "infer_from_Xs",
    "infer_from_Ys",
    "init_vae_match",
    "predict_from_model",
    "train_vae_model",
    "vae_match_step",
    "vae_match_steps",
]
