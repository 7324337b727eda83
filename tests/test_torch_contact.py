"""Port parity: the contact geometry of panda_gym_tpu_torch against
panda_gym_tpu, both on the CPU.

ops/contact.py is fed the same seeded numpy inputs on both sides: random
segments, spheres and oriented boxes, plus degenerate (zero-length)
segments, points inside boxes and exact ties of the nearest-face argmin
(coordinates that are exact binary fractions of the half extents, and
zeros, whose sign is taken as +1).  Each function runs on two layouts:
flat (N pairs) and broadcast ((4, 16) capsules or points against 16
spheres or boxes, the capsules x obstacles grid of the collision check).
Tolerances: atol 1e-6 on distances, 1e-5 on points and normals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panda_gym_tpu.ops import contact as JC

from panda_gym_tpu_torch.ops import contact as TC

N = 64
ATOL_D, ATOL_P = 1e-6, 1e-5


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)


def _cases(seed=0):
    """Segments (some degenerate), spheres, boxes (some axis-aligned), and
    points: random, inside the boxes, and on exact nearest-face ties."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-0.5, 0.5, (N, 3))
    p1 = rng.uniform(-0.5, 0.5, (N, 3))
    p1[:8] = p0[:8]                                   # degenerate segments
    q0 = rng.uniform(-0.5, 0.5, (N, 3))
    q1 = rng.uniform(-0.5, 0.5, (N, 3))
    q1[8:12] = q0[8:12]
    q1[12:16] = q0[12:16] + (p1[12:16] - p0[12:16])   # parallel segments
    half = rng.uniform(0.02, 0.3, (N, 3))
    half[:16] = 0.25                                  # exact binary fractions
    x = rng.uniform(-0.6, 0.6, (N, 3))
    x[16:32] = half[16:32] * rng.uniform(-0.9, 0.9, (16, 3))   # inside
    # exact ties of the face gaps: |x| = (0.125, 0.125, 0) in a cube of
    # half 0.25, with every sign, and the box center itself
    ties = np.array([[0.125, 0.125, 0.0], [-0.125, 0.125, 0.0],
                     [0.125, -0.125, 0.0], [0.0, 0.125, 0.125],
                     [0.125, 0.0, 0.125], [0.0, 0.0, 0.0],
                     [0.125, 0.125, 0.125], [-0.125, -0.125, -0.125]])
    x[:8] = ties
    R = _rotations(rng, N)
    R[:16] = np.eye(3)
    return {k: v.astype(np.float32) for k, v in dict(
        p0=p0, p1=p1, q0=q0, q1=q1, half=half, x=x, R=R,
        center=rng.uniform(-0.3, 0.3, (N, 3)),
        rc=rng.uniform(0.0, 0.1, N), rs=rng.uniform(0.0, 0.1, N)).items()}


def _check(t_out, j_out, atols):
    for i, (t, j, atol) in enumerate(zip(t_out, j_out, atols)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol,
                                   err_msg=f"output {i}")


# the capsule or point side of each query; the rest is the obstacle side
_GRID = ("p0", "p1", "q0", "q1", "rc", "x")


def _both(fn_t, fn_j, names, c, layout="flat"):
    if layout == "broadcast":
        c = {k: (v.reshape(4, 16, *v.shape[1:]) if k in _GRID else v[:16])
             for k, v in c.items()}
    return (fn_t(*(torch.as_tensor(c[k]) for k in names)),
            fn_j(*(jnp.asarray(c[k]) for k in names)))




def test_closest_on_segment(layout="flat"):
    c = _cases()
    t, j = _both(TC.closest_on_segment, JC.closest_on_segment,
                 ("p0", "p1", "x"), c, layout)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL_P)


def test_segment_segment_closest(layout="flat"):
    c = _cases(1)
    _check(*_both(TC.segment_segment_closest, JC.segment_segment_closest,
                  ("p0", "p1", "q0", "q1"), c, layout), (ATOL_P, ATOL_P))


def test_capsule_sphere_distance(layout="flat"):
    c = _cases(2)
    _check(*_both(TC.capsule_sphere_distance, JC.capsule_sphere_distance,
                  ("p0", "p1", "rc", "center", "rs"), c, layout),
           (ATOL_D, ATOL_P, ATOL_P))


def test_point_box_closest(layout="flat"):
    c = _cases(3)
    t, j = _both(TC.point_box_closest, JC.point_box_closest, ("x", "half"), c,
                 layout)
    _check(t, j, (ATOL_P, ATOL_D))
    if layout == "flat":
        assert (t[1][16:32] < 0).all()      # the points inside read negative


def test_inside_normal(layout="flat"):
    c = _cases(4)
    t, j = _both(TC._inside_normal, JC._inside_normal, ("x", "half"), c,
                 layout)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_capsule_box_distance(layout="flat"):
    c = _cases(5)
    _check(*_both(TC.capsule_box_distance, JC.capsule_box_distance,
                  ("p0", "p1", "rc", "center", "R", "half"), c, layout),
           (ATOL_D, ATOL_P, ATOL_P, ATOL_P))


def test_sphere_box_distance(layout="flat"):
    c = _cases(6)
    c["x"][:8] += c["center"][:8]           # the tie points, box-relative
    _check(*_both(TC.sphere_box_distance, JC.sphere_box_distance,
                  ("x", "rs", "center", "R", "half"), c, layout),
           (ATOL_D, ATOL_P, ATOL_P, ATOL_P))


@pytest.mark.parametrize("test", [
    test_closest_on_segment, test_segment_segment_closest,
    test_capsule_sphere_distance, test_point_box_closest, test_inside_normal,
    test_capsule_box_distance, test_sphere_box_distance],
    ids=lambda f: f.__name__[5:])
def test_broadcast_layout(test):
    """Each query on the broadcast layout."""
    test("broadcast")
