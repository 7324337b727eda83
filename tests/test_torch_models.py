"""Port parity: model tables, kinematics and the Bullet goldens.

The same inputs, drawn with numpy from a seed, go through panda_gym_tpu
(JAX, on the CPU) and panda_gym_tpu_torch (PyTorch, on the CPU).
"""
import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.models import panda_constants as jpc
from panda_gym_tpu.models.panda import make_panda_model as jax_make_panda
from panda_gym_tpu.ops import kinematics as JK

from panda_gym_tpu_torch import convert
from panda_gym_tpu_torch.math.transforms import quat_to_mat
from panda_gym_tpu_torch.models import panda_constants as tpc
from panda_gym_tpu_torch.models.chain import ARRAY_FIELDS, STATIC_FIELDS
from panda_gym_tpu_torch.models.panda import EE_SITE
from panda_gym_tpu_torch.models.panda import make_panda_model as torch_make_panda
from panda_gym_tpu_torch.ops import kinematics as TK
from panda_gym_tpu_torch.ops import scalarized as TS
from panda_gym_tpu_torch.utils import angle_distance, distance

VARIANTS = [
    dict(),
    dict(gripper="prismatic"),
    dict(base_position=(0.0, 0.0, 0.0), inertia="stock"),
    dict(base_position=(-0.6, 0.0, 0.0)),
]


@pytest.fixture(scope="module", params=range(len(VARIANTS)),
                ids=["welded", "prismatic", "stock", "reach_base"])
def models(request):
    kw = VARIANTS[request.param]
    return jax_make_panda(**kw), torch_make_panda(**kw)


def test_model_arrays_equal_exactly(models):
    jm, tm = models
    for k in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jm, k)), getattr(tm, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_model_static_fields_equal(models):
    jm, tm = models
    for k in STATIC_FIELDS:
        assert getattr(jm, k) == getattr(tm, k), k


def test_convert_chain_model_carries_every_table(models):
    jm, tm = models
    cm = convert.chain_model({k: getattr(jm, k)
                              for k in ARRAY_FIELDS + STATIC_FIELDS})
    for k in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(cm, k), getattr(tm, k))
    for k in STATIC_FIELDS:
        assert getattr(cm, k) == getattr(tm, k)


def test_consts_from_model_matches_jax(models):
    from panda_gym_tpu.ops import scalarized as JS

    jm, tm = models
    a, b = JS.consts_from_model(jm), TS.consts_from_model(tm)
    for f in a.__dataclass_fields__:
        assert getattr(a, f) == getattr(b, f), f


def test_constants_copy_is_identical():
    names = [n for n in dir(jpc) if n.isupper()]
    assert names
    for n in names:
        assert repr(getattr(jpc, n)) == repr(getattr(tpc, n)), n


def test_fk_and_ee_match_jax(models):
    jm, tm = models
    rng = np.random.default_rng(0)
    B, n = 16, jm.ndof
    q = rng.uniform(np.asarray(jm.q_lo), np.asarray(jm.q_hi), (B, n))
    qd = rng.normal(0.0, 1.0, (B, n))
    q, qd = q.astype(np.float32), qd.astype(np.float32)
    fk_t = TK.fk_world(tm, torch.as_tensor(q), torch.as_tensor(qd))
    for i in range(B):
        fk_j = JK.fk_world(jm, jnp.asarray(q[i]), jnp.asarray(qd[i]))
        for k in ("R", "p", "a", "om", "v"):
            np.testing.assert_allclose(getattr(fk_t, k)[i].numpy(),
                                       np.asarray(getattr(fk_j, k)),
                                       atol=1e-5, err_msg=k)
        for s in (1, 5, EE_SITE):
            np.testing.assert_allclose(
                TK.site_com_position(tm, fk_t, s)[i].numpy(),
                np.asarray(JK.site_com_position(jm, fk_j, s)), atol=1e-5)
            np.testing.assert_allclose(
                TK.site_com_velocity(tm, fk_t, s)[i].numpy(),
                np.asarray(JK.site_com_velocity(jm, fk_j, s)), atol=1e-5)


def test_distance_rounds_like_jax():
    from panda_gym_tpu.utils import angle_distance as j_ang
    from panda_gym_tpu.utils import distance as j_dist

    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.05, (64, 3))).astype(np.float32)
    np.testing.assert_array_equal(
        distance(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(j_dist(jnp.asarray(a), jnp.asarray(b))))
    qa = rng.normal(size=(64, 4)).astype(np.float32)
    qb = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        angle_distance(torch.as_tensor(qa), torch.as_tensor(qb)).numpy(),
        np.asarray(j_ang(jnp.asarray(qa), jnp.asarray(qb))), atol=1e-6)


def test_quat_to_mat_matches_jax():
    from panda_gym_tpu.math.transforms import quat_to_mat as j_q2m

    rng = np.random.default_rng(4)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(quat_to_mat(torch.as_tensor(q)).numpy(),
                               np.asarray(j_q2m(jnp.asarray(q))), atol=1e-6)


# --------------------------------------------------------------------------
# Bullet goldens (tests/test_bullet_goldens.py:63-146), through the port
# --------------------------------------------------------------------------

def _stock_fk(q):
    tm = torch_make_panda(base_position=(0.0, 0.0, 0.0), inertia="stock")
    q = torch.as_tensor(np.asarray(q, np.float32))[None]
    return tm, TK.fk_world(tm, q, torch.zeros_like(q))


def test_golden_link_com_position():
    """test/pybullet_test.py:124-136: link 1 CoM at q = 0, atol 1e-3."""
    tm, fk = _stock_fk(np.zeros(7))
    np.testing.assert_allclose(TK.site_com_position(tm, fk, 1)[0].numpy(),
                               [0.000, 0.060, 0.373], atol=1e-3)


@pytest.fixture(scope="module")
def golden_step():
    """Stock robot at the origin, joint 5 commanded to 0.3 under a 5 N*m
    clamp, one 20-substep step through the port's batched physics
    (test/pybullet_test.py:110-121)."""
    tm = torch_make_panda(base_position=(0.0, 0.0, 0.0), inertia="stock")
    effort = tm.effort.copy()
    effort[5] = 5.0
    tm = dataclasses.replace(tm, effort=effort)
    step = TS.make_batched_motor_steps(tm, n_substeps=20, dt=1.0 / 500.0,
                                       ctrl_mode=TS.CTRL_POSITION)
    z = torch.zeros(1, 7)
    tgt = z.clone()
    tgt[0, 5] = 0.3
    q, qd = step(z, z, tgt)
    return tm, q, qd, TK.fk_world(tm, q, qd)


def test_golden_link_velocity(golden_step):
    """test/pybullet_test.py:156-170 at atol 1e-3."""
    tm, _, _, fk = golden_step
    np.testing.assert_allclose(TK.site_com_velocity(tm, fk, 5)[0].numpy(),
                               [-0.0068, 0.0000, 0.1186], atol=1e-3)


def test_golden_link_angular_velocity(golden_step):
    """test/pybullet_test.py:172-187 at atol 1e-3."""
    tm, _, _, fk = golden_step
    om = fk.om[0, tm.site_body_tuple[5]].numpy()
    np.testing.assert_allclose(om, [0.0, -2.969, 0.0], atol=1e-3)


def test_golden_joint_angle(golden_step):
    """test/pybullet_test.py:189-204 at atol 1e-3."""
    _, q, _, _ = golden_step
    assert float(q[0, 5]) == pytest.approx(0.063, abs=1e-3)


def test_fk_of_bullet_ik_golden():
    """Bullet's IK golden joint vector (test/pybullet_test.py:254-266)
    through the port's FK reaches the requested pose: position within
    7e-2 (the golden itself misses it, test_bullet_goldens.py:126-135) and
    orientation within 1e-2 rad of the target quaternion (the JAX test's
    5e-3 on the quaternion)."""
    golden = np.array([1.000, 1.223, -1.113, -0.021, -0.917, 0.666, -0.499])
    tm, fk = _stock_fk(golden)
    R, p = TK.site_frame(tm, fk, 6)
    np.testing.assert_allclose(p[0].numpy(), [0.4, 0.5, 0.6], atol=7e-2)
    target = np.asarray([0.707, -0.02, 0.02, 0.707], np.float32)
    R_t = quat_to_mat(torch.as_tensor(target / np.linalg.norm(target)))
    cos = (torch.trace(R[0].T @ R_t) - 1.0) / 2.0
    assert float(torch.arccos(torch.clamp(cos, -1.0, 1.0))) < 1e-2


def test_port_imports_nothing_of_jax():
    """Static check over every module of the port and chip_smoke.py: no
    import of JAX or of the JAX package anywhere; gymnasium only inside a
    function (the gym adapters import it at first use)."""
    import ast

    root = os.path.join(os.path.dirname(__file__), "..")
    pkg = os.path.join(root, "panda_gym_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(root, "chip_smoke.py"),
              os.path.join(root, "tests", "test_torch_cuda.py")]
    banned = ("jax", "flax", "optax", "panda_gym_tpu")
    for path in files:
        tree = ast.parse(open(path).read())
        in_function = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                in_function.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
                assert (n.split(".")[0] != "gymnasium"
                        or id(node) in in_function), (path, n)


def test_port_modules_import_without_jax():
    """Importing every module of the port loads no JAX module."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import panda_gym_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'gymnasium', 'panda_gym_tpu')]\n"
        "assert not bad, bad\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_constants_module_is_numpy_only():
    spec = importlib.util.find_spec("panda_gym_tpu_torch.models.panda_constants")
    src = open(spec.origin).read()
    assert "import torch" not in src and "import jax" not in src
