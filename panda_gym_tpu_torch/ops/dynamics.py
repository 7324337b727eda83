"""Articulated rigid-body dynamics for ChainModel, batch leading (port of
panda_gym_tpu/ops/dynamics.py).

The JAX module is single-env and batched with vmap; here every tensor
carries the env batch as its leading dimension.  ``rnea``, ``bias_force``,
``crba`` and ``motor_substep`` are built on ops/scalarized.py's component
form (the plain version of kernel K1), so the port keeps one Featherstone:
the same RNEA, CRBA and Cholesky, stacked into (B, ndof) tensors.

The motor substep takes the per-env path's arguments (``gravity``,
``effort``, ``tau_ext``, ``warm``, ``return_warm``) and honours the motor-LCP
mode: "exact" (the masked active-set solve, the default) or "pgs" (Bullet's
sequential impulse, ``_motor_pgs``).  Only the per-env entry points reach
this function (sim/engine.py ``per_env``); the batched steps run K1.

The knobs are read from the same environment variables, with the same
defaults, as the JAX package (dynamics.py:229-287).
"""
import os as _os

import torch

# PyBullet's default positionGain for POSITION_CONTROL motors.
POSITION_GAIN = 0.1
CTRL_POSITION = 0
CTRL_VELOCITY = 1

# masked active-set refinements of the motor box-LCP: cold solve, and per
# substep when warm-started from the previous substep's active set
MOTOR_LCP_ITERS = max(1, int(_os.environ.get("PANDA_MOTOR_LCP_ITERS", "3")))
MOTOR_LCP_WARM_ITERS = max(
    1, int(_os.environ.get("PANDA_MOTOR_LCP_WARM_ITERS", "1")))

# whether the batched path carries the warm active set across substeps
LCP_WARM_START = _os.environ.get("PANDA_LCP_WARM", "1") != "0"


def lcp_warm_default(path_default: bool) -> bool:
    """Path default unless PANDA_LCP_WARM is set explicitly in the env."""
    if "PANDA_LCP_WARM" in _os.environ:
        return LCP_WARM_START
    return path_default


# Motor LCP solver of the per-env path: "exact" (masked active set, the
# default) or "pgs" (Bullet-emulating sequential impulse with PGS_ITERS
# sweeps; PyBullet's numSolverIterations default is 50), which reproduces
# Bullet's partially converged golden values.
LCP_MODE = "exact"
PGS_ITERS = 50

GRAVITY = (0.0, 0.0, -9.81)  # pybullet.py:54


def set_lcp_mode(mode: str, pgs_iters=None) -> None:
    """Switch the per-env motor-LCP solver ("exact" / "pgs").  The steps
    read the mode at each call, so it takes effect at the next step; there
    is no compiled trace to drop, as the JAX package's setter must."""
    global LCP_MODE, PGS_ITERS
    if mode not in ("exact", "pgs"):
        raise ValueError(f"unknown LCP mode {mode!r} (exact|pgs)")
    if pgs_iters is not None:
        PGS_ITERS = int(pgs_iters)
    LCP_MODE = mode


# ---------------------------------------------------------------------------
# tensor functions over the component form


def _cols(x, ndof):
    return [x[:, d] for d in range(ndof)]


def _stack(vals, like):
    """Scalars of the component form (tensors, or folded Python floats) ->
    one (B, n) tensor."""
    B = like.shape[0]
    return torch.stack([v if torch.is_tensor(v)
                        else like.new_full((B,), float(v)) for v in vals], -1)


def _gravity(gravity):
    return tuple(float(g) for g in gravity)


def rnea(model, q, qd, qdd, gravity=GRAVITY):
    """Recursive Newton-Euler inverse dynamics (Featherstone alg. 5.1):
    (B, ndof) q, qd, qdd -> tau (B, ndof).  With qdd = 0 it is the bias
    force C(q, qd) qd + G(q)."""
    from panda_gym_tpu_torch.ops import scalarized as S
    n = model.ndof
    tau = S.rnea(S.consts_from_model(model), _cols(q, n), _cols(qd, n),
                 _cols(qdd, n), _gravity(gravity))
    return _stack(tau, q)


def bias_force(model, q, qd, gravity=GRAVITY):
    """C(q, qd) qd + G(q), (B, ndof)."""
    from panda_gym_tpu_torch.ops import scalarized as S
    n = model.ndof
    tau = S.rnea(S.consts_from_model(model), _cols(q, n), _cols(qd, n),
                 [0.0] * n, _gravity(gravity))
    return _stack(tau, q)


def crba(model, q):
    """Joint-space mass matrix by the composite-rigid-body algorithm
    (Featherstone alg. 6.2): (B, ndof) -> (B, ndof, ndof)."""
    from panda_gym_tpu_torch.ops import scalarized as S
    M = S.crba(S.consts_from_model(model), _cols(q, model.ndof))
    return torch.stack([_stack(row, q) for row in M], -2)


def _motor_pgs(M, qd_free, v_des, cap, iters: int):
    """Sequential-impulse (projected Gauss-Seidel) motor solve, Bullet's
    btMultiBodyConstraintSolver scheme (dynamics.py:289-310): one
    velocity-constraint row per motor, the impulse accumulated and clamped
    to +-cap, the velocity change propagated through the columns of M^-1,
    rows swept in joint order.  M (B, n, n); qd_free, v_des (B, n); cap (n,)
    or (B, n)."""
    n = qd_free.shape[-1]
    Minv = torch.linalg.inv(M)
    inv_diag = 1.0 / torch.diagonal(Minv, dim1=-2, dim2=-1)
    cap = torch.as_tensor(cap, dtype=qd_free.dtype,
                          device=qd_free.device).expand_as(qd_free)
    v = qd_free
    p = [torch.zeros_like(qd_free[:, 0]) for _ in range(n)]
    for _ in range(iters):
        for j in range(n):
            dp = (v_des[:, j] - v[:, j]) * inv_diag[:, j]
            p_new = torch.clamp(p[j] + dp, -cap[:, j], cap[:, j])
            dp = p_new - p[j]
            p[j] = p_new
            v = v + Minv[:, :, j] * dp[:, None]
    return v


def motor_substep(model, q, qd, target, dt: float, control_mode: int,
                  gravity=GRAVITY, position_gain: float = POSITION_GAIN,
                  tau_ext=None, effort=None, warm=None,
                  return_warm: bool = False):
    """One semi-implicit Euler substep of the motor-driven chain
    (dynamics.py:313-424), (B, ndof) tensors in and out.

    control_mode CTRL_POSITION: desired joint velocity kp (target - q) / dt;
    CTRL_VELOCITY: the target.  Each motor is a velocity constraint with an
    impulse cap effort * dt (``effort``, ndof floats, default the model's);
    the coupled box-LCP is solved exactly by the masked active set (mode
    "exact": ops/scalarized.py:motor_substep) or by PGS_ITERS sweeps of
    sequential impulse (mode "pgs").  ``warm=(sat, sign)``, (B, ndof) each,
    runs the warm refinements from a carried active set; with it (or
    ``return_warm``) the return is (q, qd, (sat, sign))."""
    from panda_gym_tpu_torch.ops import scalarized as S
    mc = S.consts_from_model(model)
    n = model.ndof
    grav = _gravity(gravity)
    eff = None if effort is None else tuple(
        float(e) for e in torch.as_tensor(effort).reshape(-1).tolist())
    want_warm = warm is not None or return_warm
    if LCP_MODE != "pgs":
        tau = None if tau_ext is None else _cols(tau_ext, n)
        w = None if warm is None else (_cols(warm[0], n), _cols(warm[1], n))
        out = S.motor_substep(mc, _cols(q, n), _cols(qd, n),
                              _cols(target, n), dt, control_mode,
                              position_gain=position_gain, tau_ext=tau,
                              warm=w, return_warm=return_warm,
                              gravity=grav, effort=eff)
        if want_warm:
            q2, qd2, (sat, sign) = out
            return (_stack(q2, q), _stack(qd2, q),
                    (torch.stack(list(sat), -1), _stack(sign, q)))
        return _stack(out[0], q), _stack(out[1], q)

    T = model.tensors(q.device)
    if control_mode == CTRL_POSITION:
        v_des = position_gain * (target - q) / dt
    else:
        v_des = target
    vel = torch.as_tensor(mc.vel_limit, dtype=q.dtype, device=q.device)
    v_des = torch.clamp(v_des, -vel, vel)
    bias = bias_force(model, q, qd, grav)
    M_c = S.crba(mc, _cols(q, n))
    if tau_ext is None:
        tau_ext = torch.zeros_like(q)
    fv = S.cholesky_solve(M_c, _cols(tau_ext - bias, n))
    qd_free = qd + dt * _stack(fv, q)
    M = torch.stack([_stack(row, q) for row in M_c], -2)
    cap = dt * torch.as_tensor(mc.effort if eff is None else eff,
                               dtype=q.dtype, device=q.device)
    qd_new = _motor_pgs(M, qd_free, v_des, cap, PGS_ITERS)
    q_new = q + qd_new * dt
    q_cl = torch.clamp(q_new, T["q_lo"], T["q_hi"])
    qd_new = torch.where(q_cl != q_new, 0.0, qd_new)
    if want_warm:
        x = (M * (qd_new - qd_free)[:, None, :]).sum(-1)
        return q_cl, qd_new, (torch.abs(x) >= cap * (1 - 1e-6),
                              torch.where(x >= 0.0, 1.0, -1.0))
    return q_cl, qd_new
