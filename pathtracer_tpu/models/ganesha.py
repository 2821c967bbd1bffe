"""Ganesha PLY scene (ganesha/bin/main.ml): a PLY triangle mesh over a huge
checkered floor, lit by two spot lights, rendered by progressive photon
mapping. The mesh rides the BVH; the 2-triangle floor sits in the scene's
brute-force triangle pool — the same split as the reference's Floor-then-BVH
two-phase intersect (main.ml:286-298), expressed as nearest-of-pools.
"""

from __future__ import annotations

import numpy as np

from ..camera import Camera
from ..io import ply
from ..ops.bvh import MeshBVH
from ..ppm import Light
from ..scene import LAMBERTIAN, SceneBuilder, TEX_CHECKER


def make_camera(aspect: float) -> Camera:
    # ganesha/bin/main.ml:30-35
    return Camera.create(eye=(328.0, 70.282, 345.0), target=(328.0, 10.0, 0.0),
                         up=(-0.00212272, 0.998201, -0.0599264),
                         aspect=aspect, vertical_fov_deg=30.0)


def load_mesh(path: str, camera: Camera) -> MeshBVH:
    p = ply.load(path)
    verts_el = p.data.get("vertex")
    if verts_el is None:
        raise ValueError("PLY has no vertex element")
    verts = np.stack([np.asarray(verts_el[k], np.float64)
                      for k in ("x", "y", "z")], axis=1)
    faces = None
    for el, cols in p.data.items():
        if "vertex_indices" in cols:
            faces = cols["vertex_indices"]
    if faces is None:
        raise ValueError("PLY has no vertex_indices")
    if isinstance(faces, list):
        faces = np.stack([f for f in faces if len(f) == 3])
    faces = np.asarray(faces)
    assert faces.shape[1] == 3, "expected triangular faces"
    n_v = len(verts)
    assert ((faces >= 0) & (faces < n_v)).all(), "face index out of bounds"
    verts_cam = camera.transform_points(verts)
    # mesh material: lambertian (0.1, 0.7, 0.2) (main.ml:108-110)
    mat_row = np.zeros(12, np.float32)
    mat_row[0] = LAMBERTIAN
    mat_row[2:5] = (0.1, 0.7, 0.2)
    mat_row[10] = 1.5
    mat_row[11] = 1.0 / 1.5
    # BVH8 re-entry walk (ops/bvh.py); falls back to BVH4 automatically
    # past the 24-bit entry range
    return MeshBVH(verts_cam, faces, mat_row, length_cutoff=8, walk="bvh8")


def build(path: str, aspect: float):
    """Returns (scene [floor only], camera, lights, mesh, bbox)."""
    cam = make_camera(aspect)
    mesh = load_mesh(path, cam)
    lo, hi = mesh.bbox_lo.astype(np.float64), mesh.bbox_hi.astype(np.float64)
    center = 0.5 * (lo + hi)

    # analytic floor (camera space; main.ml:205-260)
    s = 5000.0
    fc = np.array([center[0], lo[1], center[2]])
    xv = np.array([s, 0.0, 0.0])
    zv = np.array([0.0, 0.0, s])
    a = fc - xv - zv  # t00
    b = a + 2.0 * xv  # t01
    c = b + 2.0 * zv  # t11
    d = a + 2.0 * zv  # t10
    checker = dict(mat_kind=LAMBERTIAN, color_a=(0.2, 0.3, 0.1),
                   color_b=(0.9, 0.9, 0.9), tex_kind=TEX_CHECKER,
                   checker_wh=(500, 500))
    sb = SceneBuilder()
    sb.add_triangle(a, b, c, tex_a=(0, 0), tex_b=(0, 1), tex_c=(1, 1),
                    **checker)
    sb.add_triangle(a, c, d, tex_a=(0, 0), tex_b=(1, 1), tex_c=(1, 0),
                    **checker)
    scene = sb.build(camera=None)  # floor coords are already camera-space

    # spot lights (main.ml:267-281), bbox is camera-space
    v = hi - center
    pos1 = hi + 3.0 * v + np.array([0.0, 0.0, -400.0])
    lights = [
        Light.spot(pos1, center - pos1, power=10000.0),
        Light.spot((0.0, 0.0, 1.0), (0.0, 0.0, -1.0), power=3000.0),
    ]
    return scene, cam, lights, mesh, (lo, hi)


def build_pt(path: str, aspect: float):
    """Path-traced ganesha: the same 449k-tri mesh + checkered floor under
    the shirley sky gradient instead of spot-lit PPM. Not a reference
    executable — it exists to measure the BVH8-walk wavefront in the same
    Mrays/s units as the headline (the reference's integrator library is
    scene-agnostic, path_tracer/src/integrator.mli:4-16, so a path-traced
    mesh scene is in-contract). Returns (scene, camera, background, mesh).
    """
    from .shirley import background

    scene, cam, _lights, mesh, _bbox = build(path, aspect)
    return scene, cam, background, mesh
