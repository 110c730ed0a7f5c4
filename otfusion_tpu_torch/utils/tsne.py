"""t-SNE in PyTorch, on the tensor's device.

The JAX package draws its t-SNE with scikit-learn's ``TSNE(n_components=2,
random_state=seed, perplexity=p)`` at its defaults (``init="pca"``,
``learning_rate="auto"``, ``early_exaggeration=12``, ``max_iter=1000``,
``n_iter_without_progress=300``, ``min_grad_norm=1e-7``, the Barnes-Hut
method). The machine the port runs on has no scikit-learn, so this module
follows that call step for step:

  * P as the Barnes-Hut path builds it (``_joint_probabilities_nn``): the
    k = min(n - 1, floor(3 perplexity + 1)) nearest neighbours by squared
    Euclidean distance (rounded to float32, as scikit-learn hands them on),
    each row's precision found by scikit-learn's binary search on the
    entropy (up to 100 halvings, tolerance 1e-5, in float64), then
    symmetrised and normalised;
  * the start: PCA of the centred features (through ``torch.linalg.eigh``)
    with scikit-learn's sign rule (``svd_flip`` on the rows of V^T), cast
    to float32 and scaled so that column 0's std is 1e-4;
  * the gradient: the exact O(n^2) Student-t gradient of KL(P || Q) with
    one degree of freedom (``_kl_divergence``), where scikit-learn
    approximates the repulsion with a Barnes-Hut tree; so embeddings differ
    from scikit-learn's in coordinates, not in quality;
  * the optimiser: ``_gradient_descent`` run twice, 250 iterations on P
    times 12 with momentum 0.5, then to iteration 1000 with momentum 0.8,
    each run with fresh updates and gains (+0.2 where the update and the
    gradient disagree in sign, x0.8 elsewhere, floor 0.01), learning rate
    max(n / 48, 50), and a check every 50 iterations that stops on no
    progress or on a gradient norm below 1e-7.

The optimisation runs in float64 from the float32 start (scikit-learn's
runs in float32): near a plateau the check's "no progress" rule compares
KL values that differ in their last float32 digits, and in float64 the
card and the CPU take the same decisions and stop at the same check.

The checks are the only host reads: each one reads the error, the gradient
norm and the embedding in one copy, so a run reads the host at most 20
times (plus ``eigh``'s status check on CUDA). The PCA start draws
nothing, so ``seed`` leaves the result unchanged, as ``random_state`` does
for scikit-learn's exact PCA solvers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from otfusion_tpu_torch.utils.device import resolve_device

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
MAX_ITER = 1000
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GRAD_NORM = 1e-7
MIN_GAIN = 0.01
_SEARCH_STEPS = 100
# scikit-learn's Cython keeps these as C floats.
_PERPLEXITY_TOLERANCE = float(np.float32(1e-5))
_EPSILON_DBL = float(np.float32(1e-8))


class TSNEResult(NamedTuple):
    """The embedding (numpy float32, (n, 2)), the KL divergence at the last
    check, sklearn's ``n_iter_`` (the last iteration's index), and the number
    of checks, each of which read the host once."""

    embedding: np.ndarray
    kl_divergence: float
    n_iter: int
    checks: int


def default_perplexity(n: int) -> float:
    """The JAX function's perplexity for n points."""
    return min(30.0, max(1.0, (n - 1) / 3.0))


def n_neighbors(n: int, perplexity: float) -> int:
    return min(n - 1, int(3.0 * perplexity + 1))


def learning_rate(n: int) -> float:
    """scikit-learn's ``learning_rate="auto"`` for n points."""
    return max(n / EARLY_EXAGGERATION / 4.0, 50.0)


def knn_sqdist(x: torch.Tensor, k: int):
    """Squared Euclidean distances (float64) to each row's ``k`` nearest
    other rows, and their indices, both (n, k)."""
    x = x.to(torch.float64)
    x = x - x.mean(dim=0)
    sq = (x * x).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    d2.fill_diagonal_(math.inf)
    dist, idx = torch.topk(d2, k, dim=1, largest=False)
    return dist, idx


def binary_search_perplexity(sqdist: torch.Tensor,
                             perplexity: float) -> torch.Tensor:
    """scikit-learn's ``_binary_search_perplexity`` on (n, k) neighbour
    distances, all rows at once: each row stops at its own step, and the
    100 steps run without a host read. Returns the conditional P, (n, k)
    float64."""
    d = sqdist.to(torch.float32).to(torch.float64)
    n = d.shape[0]
    target = math.log(float(np.float32(perplexity)))
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    p_out = torch.zeros_like(d)
    for _ in range(_SEARCH_STEPS):
        p = torch.exp(-d * beta[:, None])
        s = p.sum(dim=1)
        s = torch.where(s == 0.0, _EPSILON_DBL, s)
        p = p / s[:, None]
        entropy = torch.log(s) + beta * (d * p).sum(dim=1)
        diff = entropy - target
        p_out = torch.where(done[:, None], p_out, p)
        stop = done | (diff.abs() <= _PERPLEXITY_TOLERANCE)
        up = diff > 0.0
        grown = torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0)
        shrunk = torch.where(torch.isinf(lo), beta / 2.0, (beta + lo) / 2.0)
        new_beta = torch.where(up, grown, shrunk)
        lo = torch.where(stop | ~up, lo, beta)
        hi = torch.where(stop | up, hi, beta)
        beta = torch.where(stop, beta, new_beta)
        done = stop
    return p_out


def joint_probabilities_nn(sqdist: torch.Tensor, idx: torch.Tensor,
                           perplexity: float) -> torch.Tensor:
    """Dense symmetric P (n, n) float64 from the neighbour distances, as
    ``_joint_probabilities_nn`` builds its sparse one."""
    cond = binary_search_perplexity(sqdist, perplexity)
    n = cond.shape[0]
    p = torch.zeros(n, n, dtype=torch.float64, device=cond.device)
    p.scatter_(1, idx, cond)
    p = p + p.T
    return p / p.sum().clamp_min(MACHINE_EPSILON)


def pca_init(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """scikit-learn's PCA projection with ``svd_flip`` on V^T's rows, cast
    to float32 and scaled so that column 0's (population) std is 1e-4.

    The principal directions come from ``torch.linalg.eigh`` of the smaller
    of the Gram and covariance matrices (float64), not from an SVD: on CUDA
    ``torch.linalg.svd`` reads the host twice to check its status, ``eigh``
    once."""
    x = x.to(torch.float64)
    xc = x - x.mean(dim=0)
    n, d = xc.shape
    if n <= d:
        evals, evecs = torch.linalg.eigh(xc @ xc.T)
        u = evecs[:, -n_components:].flip(1)
        sv = evals[-n_components:].flip(0).clamp_min(0.0).sqrt()
        vh = (u.T @ xc) / sv.clamp_min(1e-300)[:, None]
    else:
        vh = torch.linalg.eigh(xc.T @ xc)[1][:, -n_components:].flip(1).T
    pick = vh.abs().argmax(dim=1, keepdim=True)
    vh = vh * torch.sign(torch.gather(vh, 1, pick))
    emb = (xc @ vh.T).to(torch.float32)
    return emb / emb[:, 0].std(unbiased=False) * 1e-4


def kl_divergence(y: torch.Tensor, p: torch.Tensor):
    """KL(P || Q) and its gradient for the embedding ``y`` (n, 2), Q the
    Student-t similarities with one degree of freedom, as
    ``_kl_divergence`` computes them (Q floored at float64's eps). Both in
    ``y``'s dtype; the KL is a 0-d tensor."""
    d2 = torch.zeros(y.shape[0], y.shape[0], dtype=y.dtype, device=y.device)
    for c in range(y.shape[1]):
        diff = y[:, c, None] - y[None, :, c]
        d2 = d2 + diff * diff
    w = 1.0 / (1.0 + d2)
    w.fill_diagonal_(0.0)
    q = (w / w.sum()).clamp_min(MACHINE_EPSILON)
    kl = (p * torch.log(p.clamp_min(MACHINE_EPSILON) / q)).sum()
    pq = (p - q) * w
    grad = 4.0 * (pq.sum(dim=1, keepdim=True) * y - pq @ y)
    return kl, grad


def _gradient_descent(y, p, it, max_iter, momentum, lr,
                      n_iter_without_progress):
    """scikit-learn's ``_gradient_descent``; returns (y, error, last
    iteration, host embedding at the last check, checks)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    host_y, checks = None, 0
    for i in range(it, max_iter):
        kl, grad = kl_divergence(y, p)
        gains = torch.where(update * grad < 0.0, gains + 0.2, gains * 0.8)
        gains = gains.clamp_min(MIN_GAIN)
        grad = grad * gains
        update = momentum * update - lr * grad
        y = y + update
        # Both runs end on a multiple of N_ITER_CHECK, so the last
        # iteration is always a check.
        if (i + 1) % N_ITER_CHECK == 0:
            # One read: the error, the gradient norm and the embedding.
            got = torch.cat([kl.reshape(1), torch.linalg.vector_norm(
                grad).reshape(1), y.reshape(-1)]).cpu().numpy()
            checks += 1
            error, grad_norm = float(got[0]), float(got[1])
            host_y = got[2:].reshape(y.shape)
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i, host_y, checks


def tsne(features, perplexity: float | None = None,
         device: str | torch.device = "cuda", init=None) -> TSNEResult:
    """Embed ``features`` (n, d), a numpy array or a tensor, in 2-D on
    ``device`` (the CUDA device unless the caller passes the CPU), from
    ``init`` (n, 2) where given, as scikit-learn's ``init=ndarray``, else
    from the PCA start."""
    device = resolve_device(device)
    x = torch.as_tensor(features).to(device)
    n = x.shape[0]
    if perplexity is None:
        perplexity = default_perplexity(n)
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"n_samples ({n})")
    dist, idx = knn_sqdist(x, n_neighbors(n, perplexity))
    p = joint_probabilities_nn(dist, idx, perplexity)
    y = (pca_init(x) if init is None else torch.as_tensor(
        init, dtype=torch.float32).to(device)).to(torch.float64)
    lr = learning_rate(n)
    y, _, it, _, checks = _gradient_descent(
        y, p * EARLY_EXAGGERATION, 0, EXPLORATION_ITERS, 0.5, lr,
        EXPLORATION_ITERS)
    y, error, it, host_y, more = _gradient_descent(
        y, p, it + 1, MAX_ITER, 0.8, lr, N_ITER_WITHOUT_PROGRESS)
    return TSNEResult(host_y.astype(np.float32), error, it, checks + more)
