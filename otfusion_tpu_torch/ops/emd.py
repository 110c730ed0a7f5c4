"""Exact (unregularised) OT on the host (port of ``otfusion_tpu.ops.emd``).

Exact EMD is a small linear program on the cohorts these ablation paths
see (a few hundred points at most), solved with scipy's HiGHS;
``gw_conditional_gradient`` is unregularised GW by Frank-Wolfe over it.
Both run in float64 numpy on the host, on any machine: no kernel.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog
from scipy.sparse import csr_matrix


def emd(a: np.ndarray, b: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """Exact OT plan between histograms ``a`` (n,) and ``b`` (m,) for
    ``cost`` (n, m)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    # Equality constraints: row sums = a, column sums = b (the last column
    # is implied by the others and dropped).
    rows, cols, data = [], [], []
    for i in range(n):
        rows.extend([i] * m)
        cols.extend(range(i * m, (i + 1) * m))
        data.extend([1.0] * m)
    for j in range(m - 1):
        rows.extend([n + j] * n)
        cols.extend(range(j, n * m, m))
        data.extend([1.0] * n)
    a_eq = csr_matrix((data, (rows, cols)), shape=(n + m - 1, n * m))
    b_eq = np.concatenate([a, b[:-1]])
    res = linprog(cost.ravel(), A_eq=a_eq, b_eq=b_eq, bounds=(0, None),
                  method="highs")
    if not res.success:
        raise RuntimeError(f"EMD LP failed: {res.message}")
    return res.x.reshape(n, m)


def gw_conditional_gradient(x: np.ndarray, y: np.ndarray,
                            max_iterations: int = 100,
                            tol: float = 1e-9) -> np.ndarray:
    """Unregularised GW between point clouds ``x`` (n, d) and ``y`` (m, d')
    by Frank-Wolfe: each step linearises the quadratic objective on the
    max-scaled squared-Euclidean self-costs, solves an exact EMD for the
    direction and takes the exact line-search step on [0, 1]; it stops
    when a step moves the plan by less than ``tol`` (Frobenius)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)

    def sq(u, v):
        return (np.sum(u * u, 1)[:, None] + np.sum(v * v, 1)[None, :]
                - 2 * u @ v.T)

    cx = sq(x, x)
    cx /= max(cx.max(), 1e-30)
    cy = sq(y, y)
    cy /= max(cy.max(), 1e-30)
    n, m = cx.shape[0], cy.shape[0]
    p = np.full(n, 1.0 / n)
    q = np.full(m, 1.0 / m)
    const_c = ((cx**2) @ p)[:, None] + ((cy**2) @ q)[None, :]

    def grad(t):
        return 2.0 * (const_c - 2.0 * cx @ t @ cy.T) / 2.0  # = M(t)

    def objective(t):
        return np.sum((const_c - 2.0 * cx @ t @ cy.T) * t)

    t = np.outer(p, q)
    for _ in range(max_iterations):
        direction = emd(p, q, grad(t))
        delta = direction - t
        # f(t + s delta) is quadratic in s. f(T) = <constC, T> -
        # 2 <cx T cy^T, T>, so with symmetric cx, cy the linear coefficient
        # is <constC, delta> - 4 <cx t cy^T, delta>.
        a_quad = -2.0 * np.sum((cx @ delta @ cy.T) * delta)
        b_lin = np.sum((const_c - 4.0 * cx @ t @ cy.T) * delta)
        if abs(a_quad) < 1e-30:
            step = 1.0 if b_lin < 0 else 0.0
        else:
            step = np.clip(-b_lin / (2.0 * a_quad), 0.0, 1.0)
            if a_quad < 0:  # concave: the best step is an endpoint
                step = 1.0 if objective(t + delta) < objective(t) else 0.0
        t_new = t + step * delta
        if np.linalg.norm(t_new - t) < tol:
            t = t_new
            break
        t = t_new
    return t
