"""Path-traced mesh-pass lane compaction (integrator.trace's argsort-pack
+ static-prefix lax.switch ladder) vs the uncompacted loop.

Per-lane math is unchanged by the ladder — only the physical wavefront
width of bounces past each compaction point shrinks — so radiance must
match to XLA-contraction ulps and the segment count must match EXACTLY
(a lost segment means a live lane was dropped by the pack)."""

import os

import numpy as np
import jax.numpy as jnp

from tools.make_test_mesh import uv_sphere
from pathtracer_tpu.io import ply
from pathtracer_tpu.models import ganesha
from pathtracer_tpu.integrator import make_pass_fn


def _render(path, plan, bounces=6):
    scene, cam, bg, mesh = ganesha.build_pt(path, 1.0)
    consts = mesh.device_consts()
    os.environ["PATHTRACER_PT_COMPACT"] = plan
    try:
        pf = make_pass_fn(cam, bg, 64, 64, 1, bounces,
                          backend="triton", interpret=True, tiled=True,
                          mesh=mesh)
        rad, segs = pf(scene, 0, mesh_consts=consts)
    finally:
        os.environ.pop("PATHTRACER_PT_COMPACT", None)
    return np.asarray(rad), int(segs)


def _mesh_path(tmp_path):
    verts, faces = uv_sphere(12, 8, np.array([328.0, 60.0, 150.0]), 45.0)
    path = os.path.join(str(tmp_path), "tiny_ganesha.ply")
    ply.write_mesh(path, verts, faces)
    return path


def test_pt_compact_matches_uncompacted(tmp_path):
    path = _mesh_path(tmp_path)
    img_off, segs_off = _render(path, "0")
    # 64x64 spp=1 -> 4096 lanes; dv=2/4 keep whole kernel blocks
    img_on, segs_on = _render(path, "1:2,3:4")
    assert segs_on == segs_off
    assert np.isfinite(img_on).all() and img_on.max() > 0
    np.testing.assert_allclose(img_on, img_off, rtol=1e-3, atol=1e-4)


def test_pt_compact_overflow_falls_back_to_full_width(tmp_path):
    """At bounce 1 nearly every lane is still live, so a dv=64 prefix
    cannot hold them: the switch must take the full-width branch and the
    render must stay correct (not silently drop live lanes)."""
    path = _mesh_path(tmp_path)
    img_off, segs_off = _render(path, "0")
    img_on, segs_on = _render(path, "1:64")
    assert segs_on == segs_off
    np.testing.assert_allclose(img_on, img_off, rtol=1e-3, atol=1e-4)
