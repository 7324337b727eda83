"""The scenario URDF -> obstacle-box compiler (port of panda_gym_tpu/
native.py): the repo's native ``native/libassetc.so`` (native/assetc/
assetc.cpp, ``make -C native``) bound with ctypes and read by path, or,
where it is not built, the Python version below, a copy of
tools/compile_scenarios.py's ``boxes_from_urdf``.  Nothing is loaded at
import time."""
from __future__ import annotations

import ctypes
import math
import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "native", "libassetc.so")
_LIB: dict = {}


def _load() -> Optional[ctypes.CDLL]:
    if "lib" not in _LIB:
        lib = None
        if os.path.exists(LIB_PATH):
            lib = ctypes.CDLL(LIB_PATH)
            lib.assetc_compile_urdf_scaled.restype = ctypes.POINTER(
                ctypes.c_double)
            lib.assetc_compile_urdf_scaled.argtypes = [
                ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_int32)]
            lib.assetc_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
            lib.assetc_free.restype = None
        _LIB["lib"] = lib
    return _LIB["lib"]


def have_native() -> bool:
    return _load() is not None


def compile_urdf_boxes(urdf_path: str, base_position=(0.0, 0.0, 0.0),
                       global_scaling: float = 1.0) -> np.ndarray:
    """World AABBs (N, 6: centre + half extents) of a URDF's collision
    geometries.  ``global_scaling`` follows pybullet loadURDF: it scales the
    origins and the geometry, not ``base_position`` (the scenario manifests
    pass it, e.g. tunnel.json's globalScaling 1.4)."""
    lib = _load()
    if lib is None:
        return np.asarray(boxes_from_urdf(urdf_path, base_position,
                                          global_scaling),
                          dtype=np.float64).reshape(-1, 6)
    n = ctypes.c_int32(0)
    ptr = lib.assetc_compile_urdf_scaled(
        urdf_path.encode(), *map(float, base_position), float(global_scaling),
        ctypes.byref(n))
    if not ptr or n.value == 0:
        return np.zeros((0, 6))
    out = np.ctypeslib.as_array(ptr, shape=(n.value, 6)).copy()
    lib.assetc_free(ptr)
    return out


# ---------------------------------------------------------------------------
# the Python version (tools/compile_scenarios.py:34-139)

def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_origin(el):
    if el is None:
        return np.zeros(3), np.eye(3)
    xyz = np.array([float(v) for v in el.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in el.get("rpy", "0 0 0").split()]
    return xyz, _rpy_matrix(rpy)


def _obj_vertices(path):
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(v) for v in line.split()[1:4]])
    return np.asarray(verts)


_CORNERS = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)])


def pointsets_from_urdf(urdf_path, base_position, global_scaling=1.0):
    """World-frame collision point clouds, one per <collision> geometry:
    boxes and cylinders by their corners, meshes by their OBJ vertices;
    links placed by the fixed-joint origin chain."""
    robot = ET.parse(urdf_path).getroot()
    urdf_dir = os.path.dirname(urdf_path)
    gs = float(global_scaling)
    links = {link.get("name"): link for link in robot.findall("link")}
    link_pose = {name: (np.zeros(3), np.eye(3)) for name in links}
    joints = robot.findall("joint")
    # a few passes place chains given in any order
    for _ in range(4):
        for j in joints:
            parent = j.find("parent").get("link")
            child = j.find("child").get("link")
            oxyz, oR = _parse_origin(j.find("origin"))
            pp, pR = link_pose.get(parent, (np.zeros(3), np.eye(3)))
            link_pose[child] = (pp + pR @ (gs * oxyz), pR @ oR)
    out = []
    for name, link in links.items():
        lp, lR = link_pose[name]
        for col in link.findall("collision"):
            oxyz, oR = _parse_origin(col.find("origin"))
            gp = lp + lR @ (gs * oxyz)
            gR = lR @ oR
            geom = col.find("geometry")
            if geom is None:
                continue
            box, mesh = geom.find("box"), geom.find("mesh")
            cyl = geom.find("cylinder")
            if box is not None:
                size = gs * np.array([float(v)
                                      for v in box.get("size").split()])
                pts = gp + (_CORNERS * size / 2) @ gR.T
            elif mesh is not None:
                scale = np.array([float(v) for v in
                                  mesh.get("scale", "1 1 1").split()])
                mesh_path = os.path.normpath(
                    os.path.join(urdf_dir, mesh.get("filename")))
                if not os.path.exists(mesh_path):
                    continue
                pts = gp + (_obj_vertices(mesh_path) * scale * gs) @ gR.T
            elif cyl is not None:
                r = gs * float(cyl.get("radius"))
                length = gs * float(cyl.get("length"))
                pts = gp + (_CORNERS * np.array([r, r, length / 2])) @ gR.T
            else:
                continue
            out.append(pts + np.asarray(base_position))
    return out


def boxes_from_urdf(urdf_path, base_position, global_scaling=1.0):
    """World AABB per collision geometry: [cx, cy, cz, hx, hy, hz]."""
    out = []
    for pts in pointsets_from_urdf(urdf_path, base_position, global_scaling):
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        center = (lo + hi) / 2
        half = (hi - lo) / 2
        out.append([*np.round(center, 5).tolist(),
                    *np.round(half, 5).tolist()])
    return out
