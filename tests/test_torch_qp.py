"""Port parity: the batched ADMM QP solver of panda_gym_tpu_torch
(ops/qp.py) against panda_gym_tpu's solve_qp_admm, both on the CPU.

The two problems of tests/test_rl.py:88-100, and 8 random 13-variable
problems with 75 rows (the NEO QP's size on the tunnel scene: 6 equality,
14 joint-damper, 42 obstacle and 13 bound rows), drawn with numpy from a
seed.  Tolerance atol 1e-5 on the solution.  The solve also reads nothing
back to the host and runs a fixed number of operations per iteration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from panda_gym_tpu.ops.qp import solve_qp_admm as jax_solve

from panda_gym_tpu_torch.ops.qp import solve_qp_admm

ATOL = 1e-5


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays]


def _random_problems(seed, B=8, n=13, m=75, n_eq=6):
    """Convex problems: Q = M M^T / n + 0.01 I, c ~ N(0, 1), A ~ N(0, 1),
    l < 0 < u with the first n_eq rows equalities."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.01 * np.eye(n)
    c = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    l = rng.uniform(-2.0, -0.1, (B, m))
    u = rng.uniform(0.1, 2.0, (B, m))
    l[:, :n_eq] = u[:, :n_eq] = rng.uniform(-0.5, 0.5, (B, n_eq))
    return [a.astype(np.float32) for a in (Q, c, A, l, u)]


@pytest.mark.parametrize("case", [
    # unconstrained minimum (1, 2) clipped to the box [0, 1]^2
    (np.eye(2), [-1.0, -2.0], np.eye(2), [0.0, 0.0], [1.0, 1.0], [1, 1]),
    # min |x|^2 on x1 + x2 = 1
    (np.eye(2), [0.0, 0.0], [[1.0, 1.0]], [1.0], [1.0], [0.5, 0.5]),
], ids=["box", "equality"])
def test_rl_cases_match_jax(case):
    Q, c, A, l, u, want = case
    xj, rj = jax_solve(*map(jnp.asarray, _t(Q, c, A, l, u)))
    x, r = solve_qp_admm(*[a[None] for a in _t(Q, c, A, l, u)])
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_allclose(r[0].numpy(), np.asarray(rj), atol=ATOL)
    np.testing.assert_allclose(x[0].numpy(), want, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_problems_match_jax(seed):
    P = _random_problems(seed)
    xj, rj = jax.vmap(jax_solve)(*map(jnp.asarray, P))
    x, r = solve_qp_admm(*map(torch.as_tensor, P))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=ATOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=ATOL)
    # the rows bind: some of the solutions sit on a bound
    Ax = np.einsum("bmn,bn->bm", P[2], np.asarray(xj))
    assert (np.isclose(Ax, P[4], atol=1e-3) | np.isclose(Ax, P[3], atol=1e-3)
            )[:, 6:].any()


# operators that only make a view of their input: no launch on the card
VIEWS = {"expand", "view", "_unsafe_view", "unsqueeze", "transpose",
         "select", "slice", "alias", "t", "permute", "squeeze", "reshape",
         "detach", "unbind", "split"}


class _Ops(TorchDispatchMode):
    """Counts the operator calls other than views, and the reads of a value
    back to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n += name not in VIEWS
        self.reads += name in ("_local_scalar_dense", "item")
        return func(*args, **(kwargs or {}))


def test_no_host_read_and_fixed_operations_per_iteration():
    """No iteration reads a value back (the card would wait), and each
    iteration runs the same dozen operations whatever the batch."""
    counts = {}
    for B in (2, 8):
        P = [torch.as_tensor(a[:B]) for a in _random_problems(0)]
        for n_iters in (10, 11):
            with _Ops() as ops:
                solve_qp_admm(*P, n_iters=n_iters)
            assert ops.reads == 0
            counts[B, n_iters] = ops.n
    per_iter = counts[8, 11] - counts[8, 10]
    assert per_iter == counts[2, 11] - counts[2, 10]
    assert counts[8, 10] == counts[2, 10]
    assert per_iter <= 14
