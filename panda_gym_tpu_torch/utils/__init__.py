"""Vector math helpers mirroring the reference's panda_gym/utils.py
(port of panda_gym_tpu/utils/__init__.py)."""
import torch


def distance(a, b):
    """L2 distance rounded to 6 decimals — the rounding is part of the
    reference's observable semantics (utils.py:4-16)."""
    d = torch.linalg.vector_norm(a - b, dim=-1)
    return torch.round(d * 1e6) / 1e6


def angle_distance(a, b):
    """Quaternion geodesic distance 1 - <a,b>^2 (utils.py:19-31)."""
    return 1.0 - torch.sum(a * b, dim=-1) ** 2


def unit_vector(a, b):
    """Unit vector from a to b, 0 where they coincide (utils.py:33-35)."""
    v = b - a
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(n > 0, v / torch.where(n > 0, n, 1.0), 0.0)
