"""Dense OSQP-style ADMM for small QPs, batch leading (port of
panda_gym_tpu/ops/qp.py).

The NEO controller's 13-variable QP for a whole batch of envs at once:

    minimize   1/2 x^T Q x + c^T x
    subject to l <= A x <= u        (equalities: l == u)

A fixed count of iterations and no early exit, so the solve never reads a
value back to the host.  The JAX function refactors K with its unrolled
Cholesky in every iteration; K does not change, so here it is factored once
per call (``cholesky_ex``, no info check) and inverted against its factor
with two triangular solves, and each iteration applies the inverse as one
batched product: about a dozen launches per iteration whatever the batch.
Callers run it with TF32 off (ops/linalg.py ``_hi_prec``).
"""
from __future__ import annotations

import torch


def solve_qp_admm(Q, c, A, l, u, n_iters: int = 60, rho: float = 0.1,
                  sigma: float = 1e-6, alpha: float = 1.6):
    """OSQP ADMM iteration (Stellato et al. 2020) with fixed rho for a batch
    of problems: Q (B, n, n), c (B, n), A (B, m, n), l and u (B, m).

    Returns (x (B, n), residual norm (B,))."""
    B, n = c.shape
    m = A.shape[1]
    At = A.transpose(1, 2)
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    K = Q + sigma * eye + rho * (At @ A)
    L, _ = torch.linalg.cholesky_ex(K)
    L_inv = torch.linalg.solve_triangular(L, eye.expand(B, n, n), upper=False)
    K_inv = L_inv.transpose(1, 2) @ L_inv

    x = c.new_zeros(B, n, 1)
    z = c.new_zeros(B, m, 1)
    y = c.new_zeros(B, m, 1)
    c, l, u = c[..., None], l[..., None], u[..., None]
    for _ in range(n_iters):
        rhs = torch.add(At @ (rho * z - y) - c, x, alpha=sigma)
        x = K_inv @ rhs
        Ax = A @ x
        z_tilde = torch.add(alpha * Ax, z, alpha=1.0 - alpha)
        z_new = torch.clamp(z_tilde + y / rho, l, u)
        y = torch.add(y, z_tilde - z_new, alpha=rho)
        z = z_new
    Ax = A @ x
    resid = torch.linalg.vector_norm(torch.clamp(Ax, l, u) - Ax, dim=(1, 2))
    return x[..., 0], resid
