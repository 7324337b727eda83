"""Port parity: the batched NEO prior of panda_gym_tpu_torch (ops/neo.py)
against panda_gym_tpu's compute_action_neo, both on the CPU.

For reachao1 (one sphere), reachao2 (two spheres) and tunnel (three boxes)
at B = 8 from JAX's reset states: env 0's first obstacle is moved to ~0.1 m
of the end effector and env 1's joint 4 within 0.3 rad of its upper limit,
so that obstacle-damper and joint-damper rows are active.  JAX runs per
env, eagerly, with its solve_qp_admm wrapped to capture (Q, c, A, l, u).
Tolerances: the assembled QP atol 1e-5; the command atol and rtol 1e-4;
jacobm against jax.grad rtol 1e-5 (atol 1e-5 of each env's largest
component: the base joint and the flange joint do not move the
translational manipulability, so their components sit at the rounding
level).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from panda_gym_tpu.envs.tasks import reach_ao as jrao
from panda_gym_tpu.models import panda_constants as jpc
from panda_gym_tpu.ops import kinematics as JK
from panda_gym_tpu.ops import neo as JN

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.envs.tasks import reach_ao as trao
from panda_gym_tpu_torch.ops import kinematics as TK
from panda_gym_tpu_torch.ops import neo as TN

B = 8
ATOL_QP = 1e-5
ATOL_CMD = RTOL_CMD = 1e-4
RTOL_JACOBM = 1e-5


def _jax_states(core, n=B, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    states, obs = jax.jit(jax.vmap(core.reset))(keys)
    # env 0: the first obstacle ~0.1 m from the end effector; env 1: joint
    # 4 within 0.3 rad of its upper limit
    ee = np.asarray(obs["achieved_goal"])
    opos = np.asarray(states.obstacle_pos).copy()
    opos[0, 0] = ee[0] + np.array([0.0, 0.1, 0.1], np.float32)
    q = np.asarray(states.q).copy()
    q[1, 3] = jpc.JOINT_LIM_MAX[3] - 0.3
    return states.replace(obstacle_pos=jnp.asarray(opos), q=jnp.asarray(q))


def _take(states, b):
    return jax.tree_util.tree_map(lambda v: v[b], states)


@pytest.fixture(scope="module", params=["reachao1", "reachao2", "tunnel"])
def scene(request):
    """(JAX states, port states, port core, JAX per-env QPs and commands)."""
    jcore = jrao.make_reach_ao_core(request.param)
    states = _jax_states(jcore)
    m, ee = jcore.model, jcore.robot.ee_site
    qps, cmds = [], []
    solve = JN.solve_qp_admm

    def capture(*qp):
        qps.append([np.asarray(a) for a in qp])
        return solve(*qp)

    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "solve_qp_admm", capture)
    try:
        for b in range(B):
            s = _take(states, b)
            fk = JK.fk_world(m, s.q, s.qd)
            cmds.append(np.asarray(JN.compute_action_neo(m, ee, s, fk,
                                                         s.goal)))
    finally:
        mp.undo()
    tcore = trao.make_reach_ao_core(request.param, device="cpu")
    tstates = convert.env_state(
        {k: np.asarray(getattr(states, k)) for k in convert.FIELDS}, "cpu")
    return states, tstates, tcore, qps, np.stack(cmds)


def _port_qp(tcore, ts):
    fk = TK.fk_world(tcore.model, ts.q, ts.qd)
    return TN.assemble_qp(tcore.model, tcore.robot.ee_site, ts, fk, ts.goal)


def test_qp_assembly_matches_jax(scene):
    _, ts, tcore, qps, _ = scene
    got = _port_qp(tcore, ts)
    for name, g, w in zip("Q c A l u".split(), got,
                          (np.stack(x) for x in zip(*qps))):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL_QP, err_msg=name)
    # the rows under test are active: an obstacle damper in env 0, a joint
    # damper in env 1 (rows 6-19), and no inactive row constrains
    u = got[4]
    nj = 6 + 14
    assert (u[0, nj:-13] < 1e6).any()
    assert (u[1, 6:nj] < 1e6).any()
    A = got[2]
    assert (A[:, nj:-13][u[:, nj:-13] >= 1e6] == 0).all()


def test_command_matches_jax(scene):
    _, ts, tcore, _, want = scene
    fk = TK.fk_world(tcore.model, ts.q, ts.qd)
    got = TN.compute_action_neo(tcore.model, tcore.robot.ee_site, ts, fk,
                                ts.goal)
    assert got.shape == (B, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_CMD,
                               rtol=RTOL_CMD)
    # the qd bounds hold (panda.py:417-419)
    assert (got.abs() <= torch.as_tensor(jpc.QDLIM, dtype=torch.float32)
            + 1e-3).all()


def test_jacobm_matches_jax_grad(scene):
    states, ts, tcore, _, _ = scene
    m, ee = tcore.model, tcore.robot.ee_site
    jm_model = jrao.make_reach_ao_core("reachao1").model

    def grad(q):
        def manip(qq):
            fk = JK.fk_world(jm_model, q.at[:7].set(qq))
            x = JK.site_com_position(jm_model, fk, ee)
            J, _ = JK.point_jacobian(jm_model, fk, x,
                                     jm_model.site_body_tuple[ee])
            J = J[:, :7]
            return jnp.sqrt(jnp.maximum(jnp.linalg.det(J @ J.T), 1e-12))
        return jax.grad(manip)(q[:7])

    want = np.asarray(jax.vmap(grad)(states.q))
    with torch.no_grad():
        got = TN.jacobm(m, ee, ts.q).numpy()
    for b in range(B):
        np.testing.assert_allclose(got[b], want[b], rtol=RTOL_JACOBM,
                                   atol=RTOL_JACOBM * np.abs(want[b]).max(),
                                   err_msg=f"env {b}")


def test_rotvec_and_p_servo_match_jax():
    rng = np.random.default_rng(0)
    angles = np.concatenate([[0.0, 1e-4, np.pi - 1e-3], rng.uniform(0, 3, 5)])
    axes = rng.normal(size=(8, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(axes * angles[:, None]).as_matrix().astype(
        np.float32)
    got = TN._rotvec(torch.as_tensor(R)).numpy()
    want = np.stack([np.asarray(JN._rotvec(jnp.asarray(r))) for r in R])
    np.testing.assert_allclose(got, want, atol=1e-5)
    R2 = R[::-1].copy()
    p, p2 = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    got = TN.p_servo(*map(torch.as_tensor, (R, p, R2, p2)), 0.5).numpy()
    want = np.stack([np.asarray(JN.p_servo(*map(jnp.asarray, a), 0.5))
                     for a in zip(R, p, R2, p2)])
    np.testing.assert_allclose(got, want, atol=1e-5)


class _Ops(TorchDispatchMode):
    """Counts the operator calls and the reads of a value to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        self.reads += func.overloadpacket.__name__ in ("_local_scalar_dense",
                                                       "item")
        return func(*args, **(kwargs or {}))


def test_operations_do_not_grow_with_batch_or_obstacles(monkeypatch):
    """The obstacle rows are built for all pairs at once: the same count of
    operations at B = 2 and 5 and for 3 (tunnel) and 16 (industrial)
    obstacles, none of them a read back to the host, under no_grad as the
    evaluation calls it.  one_hot (ops/contact.py) checks its classes with
    a read on CPU tensors only (on the card a device assert does it): it is
    replaced here by the same comparison without the check."""
    monkeypatch.setattr(torch.nn.functional, "one_hot",
                        lambda k, n: (k[..., None] == torch.arange(n)).long())
    counts = {}
    for name in ("tunnel", "industrial"):
        core = trao.make_reach_ao_core(name, device="cpu")
        for n in (2, 2, 5):     # the first call builds the cached tables
            states, _ = core.batched_reset(n, torch.Generator().manual_seed(0))
            fk = TK.fk_world(core.model, states.q)
            with torch.no_grad(), _Ops() as ops:
                qd = TN.compute_action_neo(core.model, core.robot.ee_site,
                                           states, fk, states.goal)
            assert ops.reads == 0 and qd.shape == (n, 7)
            assert torch.isfinite(qd).all()
            counts[name, n] = ops.n
    assert len(set(counts.values())) == 1, counts
