"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathtracer_tpu.camera import Camera
from pathtracer_tpu.integrator import make_render_fn
from pathtracer_tpu.parallel.mesh import make_mesh, make_sharded_render_fn
from pathtracer_tpu.scene import DIELECTRIC, LAMBERTIAN, METAL, SceneBuilder


def _setup():
    cam = Camera.create(eye=(0, 0, 5), target=(0, 0, 0), up=(0, 1, 0),
                        aspect=1.0, vertical_fov_deg=60.0)
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, METAL, color_a=(0.9, 0.8, 0.7))
    b.add_sphere((-1.5, 0.2, 0.5), 0.6, LAMBERTIAN, color_a=(0.2, 0.4, 0.6))
    b.add_sphere((1.2, -0.5, 1.0), 0.4, DIELECTRIC)
    scene = b.build(camera=cam)

    def bg(d):
        t = 0.5 * (d[..., 1] + 1.0)
        return jnp.stack([t, t * 0.9, jnp.ones_like(t)], axis=-1)

    return cam, scene, bg


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device():
    cam, scene, bg = _setup()
    W, H, SPP, B = 32, 16, 8, 4
    ref_render = make_render_fn(cam, bg, W, H, SPP, B)
    want, want_segs = ref_render(scene)

    for dp, sp in [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]:
        mesh = make_mesh(dp, sp)
        render = make_sharded_render_fn(cam, bg, W, H, SPP, B, mesh)
        got, segs = render(scene)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, err_msg=f"dp={dp} sp={sp}")
        assert int(segs) == int(want_segs), (dp, sp)


def test_sharded_pads_non_divisible_shapes():
    """Odd height/spp that don't divide the mesh axes are padded, not
    rejected: padded passes are masked out of the film and padded rows are
    sliced off, so the result still matches single-device exactly."""
    cam, scene, bg = _setup()
    W, H, SPP, B = 32, 13, 5, 4  # 13 % sp != 0, 5 % dp != 0 below
    ref_render = make_render_fn(cam, bg, W, H, SPP, B)
    want, want_segs = ref_render(scene)

    for dp, sp in [(4, 2), (2, 4), (3, 2)]:
        mesh = make_mesh(dp, sp)
        render = make_sharded_render_fn(cam, bg, W, H, SPP, B, mesh)
        got, segs = render(scene)
        assert got.shape == (H, W, 3)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, err_msg=f"dp={dp} sp={sp}")
        # padded rows retrace real rays, so segs >= the unpadded count
        assert int(segs) >= int(want_segs), (dp, sp)


def test_sharded_tiled_pallas_kernels_match_single_device():
    """The GPU path — tile-major ray order + the Triton sphere kernel
    (interpret mode on CPU) — executed INSIDE shard_map, vs the same path
    on a 1x1 mesh: bit-identical across image-space shards, so a
    kernel-under-shard_map numerics or layout bug cannot hide."""
    cam, scene, bg = _setup()
    W, H, SPP, B = 64, 48, 4, 4

    def build(dp, sp):
        return make_sharded_render_fn(
            cam, bg, W, H, SPP, B, make_mesh(dp, sp),
            backend="triton", interpret=True, tiled=True)

    want, want_segs = build(1, 1)(scene)
    for dp, sp in [(1, 2), (2, 2), (1, 8), (4, 2)]:
        got, segs = build(dp, sp)(scene)
        if dp == 1:  # image-space sharding is BIT-exact
            np.testing.assert_array_equal(
                np.asarray(got), np.asarray(want), err_msg=f"sp={sp}")
        else:  # dp psum reassociates the pass sum (same as untiled test)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(want), atol=1e-5,
                err_msg=f"dp={dp} sp={sp}")
        assert int(segs) == int(want_segs), (dp, sp)


def test_ppm_multi_device_matches_single():
    """PPM eye-pass bands fan out across devices; results are bit-identical
    to single-device (the LDS sampler is positional, so placement is
    invisible — the same property the reference's tile scheduler relies on)."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    scene, cam, lights = cornell.build(1.0)
    kw = dict(iterations=1, photon_count=1200, max_bounces=3, verbose=False)
    a = PPMRenderer(scene, cam, lights, 96, 96,
                    devices=jax.devices()[:1], **kw).render()
    b = PPMRenderer(scene, cam, lights, 96, 96,
                    devices=jax.devices(), **kw).render()
    np.testing.assert_array_equal(a, b)


def test_ppm_sharded_photon_map_matches_replicated():
    """shard_photon_map=True: each device keeps only its own photon chunks
    and builds a sub-grid over them; eye bands gather a partial flux from
    every sub-grid and sum in fixed device order. Must agree with the
    replicated photon map up to FP reassociation of the flux sum."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    scene, cam, lights = cornell.build(1.0)
    kw = dict(iterations=1, photon_count=2000, max_bounces=3, verbose=False,
              devices=jax.devices())
    a = PPMRenderer(scene, cam, lights, 64, 64, **kw).render()
    b = PPMRenderer(scene, cam, lights, 64, 64, shard_photon_map=True,
                    **kw).render()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)


def test_ppm_ring_photon_map_matches_replicated():
    """shard_photon_map='ring': ONE shard_map runs the whole eye pass —
    each device walks its own image band and the photon sub-grids rotate
    around the device ring with lax.ppermute (parallel/ppm_ring.py). Must
    agree with the replicated photon map up to FP reassociation."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    scene, cam, lights = cornell.build(1.0)
    kw = dict(iterations=1, photon_count=2000, max_bounces=3, verbose=False,
              devices=jax.devices())
    a = PPMRenderer(scene, cam, lights, 64, 64, **kw).render()
    b = PPMRenderer(scene, cam, lights, 64, 64, shard_photon_map="ring",
                    **kw).render()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4)


def test_ppm_sharded_photon_map_mesh_scene(tmp_path):
    """Sharded photon map on the ganesha pattern (mesh BVH walk):
    per-device sub-grids with the walk's first-diffuse records shipped to
    every device for partial gathers."""
    import os

    from tools.make_test_mesh import uv_sphere
    from pathtracer_tpu.io import ply
    from pathtracer_tpu.models import ganesha
    from pathtracer_tpu.ppm import PPMRenderer

    verts, faces = uv_sphere(10, 6, np.array([328.0, 60.0, 150.0]), 45.0)
    path = os.path.join(str(tmp_path), "tiny_ganesha.ply")
    ply.write_mesh(path, verts, faces)
    imgs = []
    for shard in (False, True, "ring"):
        scene, cam, lights, mesh, bbox = ganesha.build(path, 1.0)
        rend = PPMRenderer(scene, cam, lights, 64, 64, iterations=1,
                           photon_count=1500, max_bounces=3, verbose=False,
                           mesh=mesh, bbox_override=bbox,
                           devices=jax.devices(), shard_photon_map=shard)
        imgs.append(rend.render())
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-6, rtol=1e-4)
    # ring mode runs the mesh BVH walk inside the shard_map ring
    np.testing.assert_allclose(imgs[0], imgs[2], atol=1e-6, rtol=1e-4)


def test_sharded_photon_trace_multi_chunk_per_device():
    """trace_photons.sharded with MULTIPLE chunks per device (reachable in
    production only past 131k lanes/device — forced here via a small
    lanes_per_call): every valid deposit of the replicated trace must
    appear exactly once across the per-device concatenations."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import make_photon_pass

    scene, cam, lights = cornell.build(1.0)
    kw = dict(photon_count=9000, max_bounces=2, backend="xla",
              lanes_per_call=1024)
    trace_a, total, _ = make_photon_pass(scene, lights,
                                         devices=jax.devices()[:1], **kw)
    trace_b, _, _ = make_photon_pass(scene, lights, devices=jax.devices(),
                                     **kw)
    pos_a, _, flux_a, ok_a = trace_a(jnp.uint32(0))
    per_dev = trace_b.sharded(jnp.uint32(0))
    # 9 chunks over 8 devices: device 0 must hold 2 chunks of deposits
    # (2 bounces x 1024 lanes each) — the path under test
    assert max(o[0].shape[0] for o in per_dev) == 2 * 2 * 1024
    rows_a = np.concatenate([np.asarray(pos_a)[np.asarray(ok_a)],
                             np.asarray(flux_a)[np.asarray(ok_a)]], axis=1)
    rows_b = np.concatenate(
        [np.concatenate([np.asarray(p)[np.asarray(ok)],
                         np.asarray(f)[np.asarray(ok)]], axis=1)
         for (p, n, f, ok) in per_dev])
    assert rows_a.shape == rows_b.shape
    order_a = np.lexsort(rows_a.T)
    order_b = np.lexsort(rows_b.T)
    np.testing.assert_array_equal(rows_a[order_a], rows_b[order_b])


def test_ppm_ring_kernel_gather_interpret():
    """The multi-GPU gather — the Triton chunk-list gather — executing
    INSIDE the ring shard_map (interpret mode on the CPU mesh),
    ppermuting (photons_t, cbox) sub-grids between hops. Must match the
    replicated hash-gather render up to flux reassociation."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu import ppm as P
    from pathtracer_tpu.parallel import ppm_ring as PR

    scene, cam, lights = cornell.build(1.0)
    W = H = 64
    pc, mb = 2000, 3
    base = P.PPMRenderer(scene, cam, lights, W, H, iterations=1,
                         photon_count=pc, max_bounces=mb, verbose=False,
                         devices=jax.devices()[:1])
    want = base.render()
    r = base.radius(1)

    devices = jax.devices()
    trace, total, dep_rows = P.make_photon_pass(
        scene, lights, pc, mb, "xla", devices=devices)
    per_dev = trace.sharded(jnp.uint32(0))
    per_dev, rows = PR.pad_deposits(per_dev, len(devices), devices)
    from pathtracer_tpu.ops.photon_chunks import build_photon_chunks
    grids = [build_photon_chunks(*o) for o in per_dev]
    jmesh = PR.make_ppm_mesh(devices)
    stacked = PR.stack_sharded_grids(grids, jmesh)
    band_rows = H // len(devices)
    raw = P.make_eye_pass(cam, W, H, mb, pc, rows, "xla",
                          grid_m=P.grid_m_for(pc), band_rows=band_rows,
                          use_kernel=True, interpret=True)
    ring = PR.make_ring_eye_pass(raw, jmesh, band_rows)(rows)
    img = ring(jnp.uint32(0), jnp.float32(r), stacked, None, scene)
    got = np.asarray(img, np.float64)[:H][::-1]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)


def test_ppm_ring_single_chunk_offset_devices():
    """Regression: a photon budget small enough for ONE trace chunk leaves
    deposits on the DEFAULT device; ring mode on a device list that does
    not start at jax.devices()[0] must still place sub-grid 0 on its ring
    device (pad_deposits pins placement)."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    scene, cam, lights = cornell.build(1.0)
    img = PPMRenderer(scene, cam, lights, 32, 32, iterations=1,
                      photon_count=512, max_bounces=2, verbose=False,
                      devices=jax.devices()[1:3],
                      shard_photon_map="ring").render()
    assert np.isfinite(img).all() and float(np.abs(img).sum()) > 0


def test_sharded_mesh_scene_matches_single_device():
    """A triangle-mesh scene (the ganesha pattern) rendered through
    make_sharded_render_fn(scene_mesh=...): the mesh walk table and
    triangle arrays must ride the shard_map boundary as replicated
    ARGUMENTS (MeshBVH.device_consts), not numpy fallbacks — indexing the
    host arrays with traced ids crashes, and closing over the device
    table re-embeds it as an HLO constant."""
    from pathtracer_tpu.ops.bvh import MeshBVH
    from pathtracer_tpu.scene import LAMBERTIAN

    cam, scene, bg = _setup()
    rs = np.random.RandomState(5)
    verts = rs.uniform(-2, 2, (40, 3)).astype(np.float32)
    faces = rs.randint(0, 40, (60, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    mat_row = np.zeros(12, np.float32)
    mat_row[0] = LAMBERTIAN
    mat_row[2:5] = (0.3, 0.5, 0.2)
    mat_row[10] = 1.5
    mat_row[11] = 1.0 / 1.5
    mesh_bvh = MeshBVH(verts, faces, mat_row, walk="octant")

    W, H, SPP, B = 32, 16, 4, 3
    want, want_segs = make_render_fn(cam, bg, W, H, SPP, B,
                                     mesh=mesh_bvh)(scene)

    for dp, sp in [(2, 2), (1, 4)]:
        render = make_sharded_render_fn(cam, bg, W, H, SPP, B,
                                        make_mesh(dp, sp),
                                        scene_mesh=mesh_bvh)
        got, segs = render(scene)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5, err_msg=f"dp={dp} sp={sp}")
        assert int(segs) == int(want_segs), (dp, sp)


def test_sharded_tiled_mesh_scene_matches_single_device():
    """The TILED sharded path with a scene_mesh: the Triton sphere kernel
    (interpret on CPU) beside the mesh walk inside shard_map — the layout
    multi-GPU ganesha renders take."""
    from pathtracer_tpu.ops.bvh import MeshBVH
    from pathtracer_tpu.scene import LAMBERTIAN

    cam, scene, bg = _setup()
    rs = np.random.RandomState(9)
    verts = rs.uniform(-2, 2, (30, 3)).astype(np.float32)
    faces = rs.randint(0, 30, (40, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    mat_row = np.zeros(12, np.float32)
    mat_row[0] = LAMBERTIAN
    mat_row[2:5] = (0.6, 0.3, 0.2)
    mat_row[10] = 1.5
    mat_row[11] = 1.0 / 1.5
    mesh_bvh = MeshBVH(verts, faces, mat_row, walk="bvh8")

    W, H, SPP, B = 64, 32, 2, 3

    def build(dp, sp):
        return make_sharded_render_fn(
            cam, bg, W, H, SPP, B, make_mesh(dp, sp),
            backend="triton", interpret=True, tiled=True,
            scene_mesh=mesh_bvh)

    want, want_segs = build(1, 1)(scene)
    got, segs = build(2, 2)(scene)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    assert int(segs) == int(want_segs)


def test_ppm_mesh_scene_multi_device_matches_single(tmp_path):
    """The ganesha pattern multi-device: mesh BVH walk + sharded photon
    chunks + eye bands across the 8 virtual devices, bit-identical to
    single-device (positional sampling makes placement invisible).
    Cornell's multi-device test has no mesh, so this is the only coverage
    of device_put'ing the walk table per device."""
    import os

    from tools.make_test_mesh import uv_sphere
    from pathtracer_tpu.io import ply
    from pathtracer_tpu.models import ganesha
    from pathtracer_tpu.ppm import PPMRenderer

    verts, faces = uv_sphere(10, 6, np.array([328.0, 60.0, 150.0]), 45.0)
    path = os.path.join(str(tmp_path), "tiny_ganesha.ply")
    ply.write_mesh(path, verts, faces)
    imgs = []
    for devices in (jax.devices()[:1], jax.devices()):
        scene, cam, lights, mesh, bbox = ganesha.build(path, 1.0)
        rend = PPMRenderer(scene, cam, lights, 64, 64, iterations=1,
                           photon_count=1500, max_bounces=3, verbose=False,
                           mesh=mesh, bbox_override=bbox, devices=devices)
        imgs.append(rend.render())
    np.testing.assert_array_equal(imgs[0], imgs[1])


@pytest.mark.slow
def test_ppm_ring_memory_scaling_production_photon_count(tmp_path):
    """The ring photon map's 1/n_devices memory claim at production scale:
    8x the reference's default -photon-count (600k = 8x75k,
    progressive_photon_map.ml:17-54 accepts arbitrary counts) over the
    8-device mesh on a mesh scene. Asserts (a) each device's hash tables
    are sized from its OWN photon share — grid_m_for(600k, 8) is exactly
    1/8 of the replicated grid_m_for(600k, 1), interacting correctly with
    the 2^24 cap — (b) the stacked sub-grid pytree really is laid out
    one-sub-grid-per-device, deposits included, and (c) the image matches
    the replicated photon map up to FP reassociation of the flux sum."""
    import os

    from tools.make_test_mesh import uv_sphere
    from pathtracer_tpu.io import ply
    from pathtracer_tpu.models import ganesha
    from pathtracer_tpu.ppm import PPMRenderer, grid_m_for

    n = 600_000
    n_dev = len(jax.devices())
    m_rep, m_ring = grid_m_for(n, 1), grid_m_for(n, n_dev)
    assert m_rep == n_dev * m_ring  # both in-range of the [2^17, 2^24] clamp

    verts, faces = uv_sphere(10, 6, np.array([328.0, 60.0, 150.0]), 45.0)
    path = os.path.join(str(tmp_path), "tiny_ganesha.ply")
    ply.write_mesh(path, verts, faces)
    grids, imgs = {}, {}
    for mode, devices in (("ring", jax.devices()),
                          (False, jax.devices()[:1])):
        scene, cam, lights, mesh, bbox = ganesha.build(path, 1.0)
        rend = PPMRenderer(
            scene, cam, lights, 64, 64, iterations=1, photon_count=n,
            max_bounces=3, verbose=False, mesh=mesh, bbox_override=bbox,
            devices=devices, shard_photon_map=mode,
            phase_cb=lambda name, v, _m=mode: grids.__setitem__(
                (name, _m), v))
        imgs[mode] = np.asarray(rend.render())

    # per-device sub-grid hash tables: (n_dev, m_ring), i.e. 1/n_dev the
    # replicated table per chip; deposits stacked one-share-per-device
    order, start, count, pos = jax.tree.leaves(grids[("grid_build",
                                                      "ring")])[:4]
    assert start.shape == count.shape == (n_dev, m_ring)
    rep_leaves = jax.tree.leaves(grids[("grid_build", False)])
    rep_start, rep_pos = rep_leaves[1], rep_leaves[3]
    assert rep_start.shape == (m_rep,)
    assert pos.shape[0] == n_dev
    # deposit share: 1/n_dev of the replicated rows + the per-chunk
    # 1024-lane x max_bounces rounding pad
    assert pos.shape[1] <= -(-rep_pos.shape[0] // n_dev) + 3 * 1024
    # every device holds exactly one shard of the stacked pytree
    assert len(start.sharding.device_set) == n_dev
    np.testing.assert_allclose(imgs["ring"], imgs[False],
                               atol=1e-6, rtol=1e-4)
