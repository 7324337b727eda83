"""Unrolled small-matrix linear algebra, batch leading (port of
panda_gym_tpu/ops/linalg.py).

For the tiny static sizes of the IK's damped normal equations (3×3 or 6×6)
an index-unrolled Cholesky is a fixed chain of elementwise operations over
the batch.  ``torch.linalg.solve`` would check its ``info`` result and so
synchronize with the host on every call on the card.  ``_hi_prec`` runs a
function with TF32 off, as the physics, the kinematics and the QPs need.
"""
from __future__ import annotations

import functools

import torch


def _hi_prec(fn):
    """Run ``fn`` with TF32 off for fp32 matrix products and convolutions,
    as panda_gym_tpu/envs/core.py:29-43 runs the JAX physics at "highest" precision; the
    previous settings are restored afterwards."""

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*a, **kw)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    return wrapped


def cholesky_solve_unrolled(M, b, eps: float = 1e-9):
    """Solve M x = b for SPD M of small static size n: M (B, n, n), b (B, n)
    -> x (B, n).  Fully unrolled Cholesky, the JAX function's order of
    operations."""
    n = M.shape[-1]
    # factorization: L lower-triangular with L @ L.T = M
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, eps))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)
