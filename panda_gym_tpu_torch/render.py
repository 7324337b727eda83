"""Software renderer: rgb_array frames without OpenGL (port of
panda_gym_tpu/render.py).

Replaces the reference's Bullet-GUI/hardware-OpenGL render path
(pybullet.py:117-180 render, camera math of
computeViewMatrixFromYawPitchRoll/FOV) with a small host-side numpy
rasterizer (painter's algorithm + Lambert shading), the JAX package's
rasterizer copied.  The robot's capsules come from the port's ``fk_world``
and ``capsule_endpoints_world`` on one env of a batched state; everything
after is numpy on the host.  Off the hot path by design: rendering is for
humans; training never calls it.  PIL is imported only to save frames.
"""
from __future__ import annotations

import numpy as np
import torch

from panda_gym_tpu_torch.math.transforms import quat_to_mat
from panda_gym_tpu_torch.ops import kinematics as K


# ---------------------------------------------------------------------------
# primitive meshes
# ---------------------------------------------------------------------------

def _box_tris(center, half, R=None):
    c = np.asarray(center, np.float64)
    h = np.asarray(half, np.float64)
    R = np.eye(3) if R is None else np.asarray(R)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * h
    corners = corners @ R.T + c
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for (a, b, cc, d) in faces:
        tris.append((corners[a], corners[b], corners[cc]))
        tris.append((corners[a], corners[cc], corners[d]))
    return tris


def _uv_sphere_tris(center, radius, n=8):
    c = np.asarray(center, np.float64)
    us = np.linspace(0, np.pi, n)
    vs = np.linspace(0, 2 * np.pi, 2 * n)
    tris = []
    for i in range(len(us) - 1):
        for j in range(len(vs) - 1):
            p = []
            for (uu, vv) in ((us[i], vs[j]), (us[i + 1], vs[j]),
                             (us[i + 1], vs[j + 1]), (us[i], vs[j + 1])):
                p.append(c + radius * np.array(
                    [np.sin(uu) * np.cos(vv), np.sin(uu) * np.sin(vv),
                     np.cos(uu)]))
            tris.append((p[0], p[1], p[2]))
            tris.append((p[0], p[2], p[3]))
    return tris


def _capsule_tris(p0, p1, r, n=6):
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    L = np.linalg.norm(axis)
    if L < 1e-9:
        return _uv_sphere_tris(p0, r, n=5)
    z = axis / L
    x = np.cross(z, [0, 0, 1.0])
    if np.linalg.norm(x) < 1e-6:
        x = np.cross(z, [0, 1.0, 0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    tris = []
    ang = np.linspace(0, 2 * np.pi, n + 1)
    for j in range(n):
        d0 = np.cos(ang[j]) * x + np.sin(ang[j]) * y
        d1 = np.cos(ang[j + 1]) * x + np.sin(ang[j + 1]) * y
        a, b = p0 + r * d0, p0 + r * d1
        c, d = p1 + r * d0, p1 + r * d1
        tris.append((a, b, c))
        tris.append((b, d, c))
    tris += _uv_sphere_tris(p0, r, n=4)
    tris += _uv_sphere_tris(p1, r, n=4)
    return tris


# ---------------------------------------------------------------------------
# scene assembly + rasterization
# ---------------------------------------------------------------------------

def _camera(target, distance, yaw, pitch, roll, width, height, fov=60.0):
    """View/projection mirroring computeViewMatrixFromYawPitchRoll (upAxis z,
    pybullet.py:161-171)."""
    yaw_r, pitch_r = np.deg2rad(yaw), np.deg2rad(pitch)
    # pybullet: camera on a sphere around target
    cam_pos = np.asarray(target, np.float64) + distance * np.array([
        np.cos(pitch_r) * np.sin(yaw_r) * -1.0,
        np.cos(pitch_r) * np.cos(yaw_r) * -1.0,
        -np.sin(pitch_r),
    ]) * np.array([1, -1, -1.0])
    fwd = np.asarray(target) - cam_pos
    fwd /= np.linalg.norm(fwd)
    up0 = np.array([0, 0, 1.0])
    right = np.cross(fwd, up0)
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    f = 0.5 * height / np.tan(np.deg2rad(fov) / 2)

    def project(pts):
        rel = pts - cam_pos
        xc = rel @ right
        yc = rel @ up
        zc = rel @ fwd
        zc = np.maximum(zc, 1e-4)
        u = width / 2 + f * xc / zc
        v = height / 2 - f * yc / zc
        return u, v, zc

    return project, fwd


def _raster(tris, colors, width, height, light=(0.4, -0.6, 0.8)):
    img = np.full((height, width, 3), 230, np.uint8)
    if not tris:
        return img
    light = np.asarray(light) / np.linalg.norm(light)
    depth_order = np.argsort([-np.mean([p[2] for p in t[3]]) for t in tris])
    for idx in depth_order:
        u, v, z, pts3, color = tris[idx]
        n = np.cross(pts3[1] - pts3[0], pts3[2] - pts3[0])
        nn = np.linalg.norm(n)
        if nn < 1e-12:
            continue
        shade = 0.55 + 0.45 * abs(n / nn @ light)
        c = np.clip(np.asarray(color) * shade * 255, 0, 255).astype(np.uint8)
        # bounding box rasterization with barycentric coords
        xmin = max(int(np.floor(u.min())), 0)
        xmax = min(int(np.ceil(u.max())), width - 1)
        ymin = max(int(np.floor(v.min())), 0)
        ymax = min(int(np.ceil(v.max())), height - 1)
        if xmin > xmax or ymin > ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1),
                             np.arange(ymin, ymax + 1))
        d = ((u[1] - u[0]) * (v[2] - v[0]) - (u[2] - u[0]) * (v[1] - v[0]))
        if abs(d) < 1e-9:
            continue
        w0 = ((xs - u[1]) * (v[2] - v[1]) - (ys - v[1]) * (u[2] - u[1])) / d
        w1 = ((xs - u[2]) * (v[0] - v[2]) - (ys - v[2]) * (u[0] - u[2])) / d
        w2 = 1.0 - w0 - w1
        mask = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
        img[ys[mask], xs[mask]] = c
    return img


def render_env(env_adapter, width=720, height=480, target_position=None,
               distance=1.4, yaw=45, pitch=-30, roll=0):
    """Render the current state of a single-env adapter (core.py:373-414
    args)."""
    return render_state(env_adapter.env, env_adapter.state, width=width,
                        height=height, target_position=target_position,
                        distance=distance, yaw=yaw, pitch=pitch, roll=roll)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def render_state(core, state, width=720, height=480, target_position=None,
                 distance=1.4, yaw=45, pitch=-30, roll=0, index: int = 0):
    """Render env ``index`` of a batched EnvState of a core (anything with
    ``model`` and ``task.scene``)."""
    model = core.model
    scene = core.task.scene
    i = index

    prims = []  # (tri_list, color)
    # ground plane patch + table
    prims.append((_box_tris(np.asarray(scene.table_center),
                            np.asarray(scene.table_half)), (0.3, 0.3, 0.3)))
    prims.append((_box_tris([0, 0, float(scene.plane_z) - 0.01],
                            [1.5, 1.5, 0.01]), (0.15, 0.15, 0.15)))
    # robot capsules
    fk = K.fk_world(model, state.q[i:i + 1], state.qd[i:i + 1])
    p0s, p1s = K.capsule_endpoints_world(model, fk)
    p0s, p1s = _np(p0s[0]), _np(p1s[0])
    radii = np.asarray(model.cap_radius)
    for c in range(len(radii)):
        prims.append((_capsule_tris(p0s[c], p1s[c], radii[c]),
                      (0.9, 0.9, 0.92)))
    # bodies
    body_pos, body_quat = _np(state.body_pos[i]), state.body_quat[i]
    for b in range(scene.nb):
        pos = body_pos[b]
        if np.allclose(pos, 0) and scene.body_mass[b] == 1.0 and \
           np.asarray(scene.body_size[b]).max() == 0.0:
            continue
        R = _np(quat_to_mat(body_quat[b]))
        size = np.asarray(scene.body_size[b])
        prims.append((_box_tris(pos, np.maximum(size, 1e-3), R),
                      (0.1, 0.9, 0.1)))
    # obstacles
    act = _np(state.obstacle_active[i])
    opos, osize = _np(state.obstacle_pos[i]), _np(state.obstacle_size[i])
    otype = _np(state.obstacle_type[i])
    for o in range(len(act)):
        if not act[o]:
            continue
        pos = opos[o]
        if np.linalg.norm(pos) > 5:
            continue
        size = osize[o]
        if int(otype[o]) == 1:
            prims.append((_box_tris(pos, size), (1.0, 0.5, 0.0)))
        else:
            prims.append((_uv_sphere_tris(pos, size[0]), (1.0, 0.1, 0.1)))
    # goal marker (skip far-away sentinel goals, e.g. the facade's)
    goal = _np(state.goal[i])
    if goal.shape[0] == 3 and np.linalg.norm(goal) < 100.0:
        prims.append((_uv_sphere_tris(goal, 0.02), (0.1, 0.9, 0.1)))

    target = target_position if target_position is not None else np.zeros(3)
    project, fwd = _camera(target, distance, yaw, pitch, roll, width, height)
    tris = []
    for tri_list, color in prims:
        for (a, b, c) in tri_list:
            pts3 = np.stack([a, b, c])
            u, v, z = project(pts3)
            if (z <= 1e-3).any():
                continue
            tris.append((u, v, z, pts3, color))
    return _raster(tris, None, width, height)


def save_video(frames, path: str, fps: int = 25) -> str:
    """Write a frame sequence as an animated GIF (PIL) or PNG directory.

    Offline replacement for the reference's Bullet-GUI mp4 capture
    (pybullet.py:41-47 "--mp4" loggingType option): rollouts render frames
    with render_state/render_env and this packs them for humans.  GIF when
    `path` ends with .gif; otherwise a directory of numbered PNGs.
    """
    import os

    frames = [np.asarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("save_video: empty frame list")
    if fps <= 0:
        raise ValueError(f"save_video: fps must be positive, got {fps}")
    if path.endswith(".gif"):
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return path
    os.makedirs(path, exist_ok=True)
    from PIL import Image
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(path, f"frame_{i:04d}.png"))
    return path
