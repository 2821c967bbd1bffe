"""Bounce-synchronous wavefront path tracer.

Data-parallel inversion of the reference's recursive per-pixel `trace_path`
(`path_tracer/src/integrator.ml:30-68`): the whole sample wavefront advances
one bounce at a time, carrying (origin, direction, attenuation, alive,
radiance) as SoA arrays; scatter events are masked selects; the film is
per-pixel radiance sums finished by one reconstruction conv + gamma.

Sampling parity with the reference (`integrator.ml:89-112`):
  - sampler dimension count D = 2 + 2*max_bounces
  - sample offset = y*W + x + pass*spp   (note `pass*spp`, NOT `pass*W*H` —
    a reference quirk that must be replicated for pixel parity)
  - dims (0,1) jitter the pixel; dims (2+2i, 3+2i) drive bounce i
  - cx = (x+dx)/W, cy = 1-(y+dy)/H; film splat lands on the sample's own
    pixel since write_sample truncates pixel+jitter coords (film_tile.ml:40-45)
Radiance identity: result = sum_i emit_i*prod(attn_<i) + prod(attn)*background
on miss; materials never emit (material.ml:59) so only the background term is
live in the path tracer.

Two backends compute the same thing: "xla" (plain jnp, every platform, the
`--interpreter` A/B oracle) and "triton" (the sphere pool's nearest hit runs
the Pallas-Triton kernel `ops/pallas/sphere_kernel.py`; everything else stays
XLA). The default is "triton" on a GPU and "xla" elsewhere. The kernel runs
in Pallas interpret mode only when a caller passes `interpret=True`.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import film
from .camera import Camera
from .ops import shading, spheres, vec
from .ops.lds import Sampler
from .scene import SphereScene, eval_texture

__all__ = ["BACKENDS", "default_backend", "resolve_backend", "trace",
           "make_pass_fn", "make_render_fn", "render_with_progress"]

BACKENDS = ("xla", "triton")


def default_backend(platform: str | None = None) -> str:
    """The kernel tier on a GPU, the plain XLA tier on any other platform
    (`platform` defaults to JAX's default backend)."""
    platform = jax.default_backend() if platform is None else platform
    return "triton" if platform == "gpu" else "xla"


def resolve_backend(backend: str | None) -> str:
    if backend is None:
        return default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return backend


def make_intersector(scene: SphereScene, backend: str | None,
                     intersect_fn=None, mesh=None, interpret: bool = False):
    """Build hit_setup(org, d, alive) -> dict of per-lane hit attributes.

    Unifies sphere and triangle pools (the reference's Shape sum type,
    cornell-box/bin/main.ml:93-155): nearest hit across both, then all
    shading inputs (point, flipped normal, uv, material columns) are computed
    with masked selects. Shared by the path tracer and the photon mapper.
    """
    from .ops import triangles as tri_ops
    from .scene import TRI_A, TRI_E1, TRI_E2, TRI_MAT, TRI_TEX

    use_kernel = resolve_backend(backend) == "triton"
    custom_intersect = intersect_fn is not None
    if not custom_intersect:
        if use_kernel:
            from .ops.pallas import sphere_kernel as sk
            table = sk.pack_spheres(scene.center, scene.radius, scene.valid)
        else:
            packed = spheres.pack_for_intersect(scene.center, scene.radius,
                                                scene.valid)
    has_tris = scene.tri_count > 0
    if has_tris:
        tp = scene.tri_pack
        tri_comps = tri_ops.pack_for_intersect(
            tp[:, TRI_A], tp[:, TRI_E1], tp[:, TRI_E2], scene.tri_valid)
    has_mesh = mesh is not None

    def hit_setup(org, d, alive, mesh_consts=None):
        """mesh_consts: the mesh's device arrays threaded through the jit
        boundary as arguments (MeshBVH.device_consts()) — closed-over
        arrays become HLO constants and multiply XLA compile time."""
        mc = mesh_consts or {}
        if custom_intersect:
            t_s, idx_s, hit_s = intersect_fn(scene, org, d)
            pk_rows = scene.shade_pack[idx_s]
        else:
            if use_kernel:
                at, idx_s, hit_s, inv_a = sk.intersect_spheres(
                    table, org, d, alive, interpret=interpret)
            else:
                at, idx_s, hit_s, inv_a = spheres.intersect_packed(
                    *packed, scene.valid, org, d)
            pk_rows = scene.shade_pack[idx_s]
            # stable per-ray t from the winner's params (sphere.ml:44-53)
            a = vec.quadrance(d)
            r_h = pk_rows[:, 3]
            t_s = spheres.stable_t(pk_rows[:, 0:3], r_h * r_h, org, d, a,
                                   inv_a)

        if has_tris:
            t_t, idx_t, hit_t = tri_ops.intersect_tris(tri_comps, org, d)
            tri_rows = scene.tri_pack[idx_t]
            use_tri = hit_t & (~hit_s | (t_t < t_s))
            hit = hit_s | hit_t
        else:
            use_tri = jnp.zeros(org.shape[:1], bool)
            hit = hit_s
        if has_mesh:
            t_cur = jnp.where(hit, jnp.where(use_tri, t_t, t_s) if has_tris
                              else t_s, spheres.BIG)
            # cap the walk at the pool winner's t — the reference's
            # floor-then-mesh two-phase intersect passes the floor hit
            # as the mesh query's t_max (ganesha/bin/main.ml:286-298);
            # slab tests against the tighter bound prune whole subtrees
            # behind the analytic floor
            t_m, u_m, v_m, idx_m, hit_m = mesh.intersect(
                org, d, t_max0=t_cur, active=alive, table=mc.get("table"))
            use_mesh = hit_m & (t_m < t_cur)
            use_tri = use_tri & ~use_mesh
            hit = hit | hit_m

        # sphere attributes
        point_s = org + t_s[..., None] * d
        n_s = vec.normalize(point_s - pk_rows[:, 0:3])

        if has_tris:
            e1 = tri_rows[:, TRI_E1]
            e2 = tri_rows[:, TRI_E2]
            t_rt, u_b, v_b = tri_ops.mt_single(tri_rows[:, TRI_A], e1, e2,
                                               org, d)
            # reference hit point is the barycentric combination, not o+t*d
            # (triangle.ml:31-37)
            point_t = tri_rows[:, TRI_A] + u_b[:, None] * e1 + v_b[:, None] * e2
            n_t = vec.normalize(vec.cross(e1, e2))
            point = vec.where3(use_tri, point_t, point_s)
            g_normal = vec.where3(use_tri, n_t, n_s)
            t = jnp.where(use_tri, t_t, t_s)
        else:
            point, g_normal, t = point_s, n_s, t_s
        if has_mesh:
            tp9 = mc.get("tri_pack9")
            if tp9 is not None:
                # one plane-major gather for all 9 winner attributes
                cols = tp9[:, idx_m]  # (9, L)
                ma, me1, me2 = cols[0:3].T, cols[3:6].T, cols[6:9].T
            else:
                ma = mc.get("tri_a", mesh.tri_a)[idx_m]
                me1 = mc.get("tri_e1", mesh.tri_e1)[idx_m]
                me2 = mc.get("tri_e2", mesh.tri_e2)[idx_m]
            point_m = ma + u_m[:, None] * me1 + v_m[:, None] * me2
            n_m = vec.normalize(vec.cross(me1, me2))
            point = vec.where3(use_mesh, point_m, point)
            g_normal = vec.where3(use_mesh, n_m, g_normal)
            t = jnp.where(use_mesh, t_m, t)

        hit_front = vec.dot(d, g_normal) < 0.0
        normal = vec.where3(hit_front, g_normal, -g_normal)

        # sphere uv from the flipped normal (sphere.ml:25-33)
        ny = jnp.clip(normal[..., 1], -1.0, 1.0)
        theta = jnp.arccos(-ny)
        phi = np.float32(np.pi) + jnp.arctan2(-normal[..., 2], normal[..., 0])
        u_tex = phi * np.float32(0.5 / np.pi)
        v_tex = theta * np.float32(1.0 / np.pi)
        mat_rows = pk_rows[:, 4:16]
        if has_tris:
            # triangle uv: barycentric interpolation (triangle.ml:47-57)
            tx = tri_rows[:, TRI_TEX]
            w_b = 1.0 - u_b - v_b
            tri_u = tx[:, 0] * w_b + tx[:, 2] * u_b + tx[:, 4] * v_b
            tri_v = tx[:, 1] * w_b + tx[:, 3] * u_b + tx[:, 5] * v_b
            u_tex = jnp.where(use_tri, tri_u, u_tex)
            v_tex = jnp.where(use_tri, tri_v, v_tex)
            mat_rows = jnp.where(use_tri[:, None], tri_rows[:, TRI_MAT],
                                 mat_rows)
        if has_mesh:
            # mesh tex coords are the fixed (t00, t01, t11) corners
            # (ganesha/bin/main.ml:105-106): tu = v, tv = u+v
            u_tex = jnp.where(use_mesh, v_m, u_tex)
            v_tex = jnp.where(use_mesh, u_m + v_m, v_tex)
            mat_rows = jnp.where(use_mesh[:, None],
                                 mc.get("mat_row", mesh.mat_row)[None, :],
                                 mat_rows)

        albedo = eval_texture(mat_rows[:, 1], mat_rows[:, 2:5],
                              mat_rows[:, 5:8], mat_rows[:, 8], mat_rows[:, 9],
                              u_tex, v_tex)
        return dict(hit=hit, t=t, point=point, normal=normal,
                    hit_front=hit_front, albedo=albedo,
                    mat_kind=mat_rows[:, 0], ior=mat_rows[:, 10],
                    ior_inv=mat_rows[:, 11])

    return hit_setup


def trace(scene: SphereScene, sampler: Sampler, org, d, offset, max_bounces: int,
          background: Callable, intersect_fn=None, backend: str | None = None,
          alive0=None, mesh=None, mesh_consts=None, interpret: bool = False):
    """Trace a wavefront of rays to completion; returns (radiance (N,3),
    segments traced (scalar int32)).

    backend: "xla", "triton" or None (see `default_backend`); interpret
    runs the Triton kernel in Pallas interpret mode (CPU tests).
    """
    from .ops import quat as quat_ops

    backend = resolve_backend(backend)
    n = org.shape[0]
    dtype = org.dtype
    attn = jnp.ones((n, 3), dtype)
    rad = jnp.zeros((n, 3), dtype)
    alive = (jnp.ones((n,), bool) if alive0 is None
             else jnp.asarray(alive0, bool))
    segments = jnp.zeros((), jnp.int32)
    hit_setup = make_intersector(scene, backend, intersect_fn, mesh=mesh,
                                 interpret=interpret)

    def bounce_step(bounce, org, d, attn, rad, alive, segments, offset):
        """One bounce at whatever (static) lane width the args carry."""
        segments = segments + jnp.sum(alive.astype(jnp.int32))
        h = hit_setup(org, d, alive, mesh_consts)
        hit = h["hit"] & alive
        miss = alive & ~hit
        rad = rad + vec.where3(miss, attn * background(d),
                               jnp.zeros_like(rad))

        q = shading.shader_quat(h["normal"])
        omega_i = quat_ops.rotate(q, -d)
        u = sampler.get(offset, 2 + 2 * bounce)
        v = sampler.get(offset, 3 + 2 * bounce)
        wo, attn_mult, ok = shading.scatter(
            h["mat_kind"], h["albedo"], h["ior"], h["ior_inv"],
            omega_i, h["hit_front"], u, v)

        dir_world = quat_ops.rotate_inv(q, wo)
        new_org = shading.world_ray(h["point"], dir_world)

        alive2 = hit & ok
        org = vec.where3(alive2, new_org, org)
        d = vec.where3(alive2, dir_world, d)
        attn = jnp.where(alive2[..., None], attn * attn_mult, attn)
        return org, d, attn, rad, alive2, segments

    # Mesh-walk lane compaction (the path-traced analog of ppm.py's
    # specular-walk ladder): a mesh scene's lanes die as they escape to
    # the sky. At each compaction bounce the live lanes are argsort-packed
    # to the front and the remaining bounces run inside a lax.switch
    # branch whose arrays are PHYSICALLY 1/divisor of the wavefront; an
    # overflow of live lanes falls back to the full-width branch, so any
    # plan is safe. Per-lane math is unchanged. Off by default: the walk
    # driver's coherence sort already packs dead lanes into tail chunks
    # whose while-loops exit in one step. Whether the ladder pays on the
    # GPU is not measured.
    # PATHTRACER_PT_COMPACT: "bounce:divisor,..." enables the ladder
    # ("0"/unset = off; malformed values are ignored).
    compact_plan = ()
    if mesh is not None and max_bounces > 2:
        env = os.environ.get("PATHTRACER_PT_COMPACT", "")
        plan = []
        if env and env != "0":
            try:
                plan = [(int(kv.split(":")[0]), int(kv.split(":")[1]))
                        for kv in env.split(",")]
            except (ValueError, IndexError):
                pass
        compact_plan = tuple(sorted(dict(
            (b, dv) for b, dv in plan
            if 1 <= b < max_bounces and dv > 1).items()))

    if backend == "triton":
        from .ops.pallas.sphere_kernel import RAY_BLOCK as blk
    else:
        blk = 8

    def compact_run(b0, b1, dv, org, d, attn, rad, alive, segments, offset):
        p = -(-max(n // dv, 1) // blk) * blk
        if p >= n:  # divisor too shallow to shrink: run plain
            for b in range(b0, b1):
                org, d, attn, rad, alive, segments = bounce_step(
                    b, org, d, attn, rad, alive, segments, offset)
            return org, d, attn, rad, alive, segments
        n_live = jnp.sum(alive.astype(jnp.int32))
        # stable: live lanes keep their relative (tile) order, preserving
        # the spatial coherence the walk driver's chunking relies on
        perm = jnp.argsort(jnp.where(alive, 0, 1).astype(jnp.int32))

        def full_branch(org_f, d_f, attn_f, offset_f):
            o2, d2, a2 = org_f, d_f, attn_f
            r2 = jnp.zeros_like(rad)
            al2, s2 = alive, jnp.zeros((), jnp.int32)
            for b in range(b0, b1):
                o2, d2, a2, r2, al2, s2 = bounce_step(
                    b, o2, d2, a2, r2, al2, s2, offset_f)
            return o2, d2, a2, r2, al2, s2

        def prefix_branch(org_f, d_f, attn_f, offset_f):
            idx = perm[:p]
            o2, d2, a2 = org_f[idx], d_f[idx], attn_f[idx]
            r2 = jnp.zeros((p, 3), org_f.dtype)
            al2, s2 = alive[idx], jnp.zeros((), jnp.int32)
            off2 = offset_f[idx]
            for b in range(b0, b1):
                o2, d2, a2, r2, al2, s2 = bounce_step(
                    b, o2, d2, a2, r2, al2, s2, off2)
            # scatter the prefix back over the full wavefront; lanes
            # outside the prefix are dead (n_live <= p on this branch),
            # so passthrough keeps them exactly
            return (org_f.at[idx].set(o2), d_f.at[idx].set(d2),
                    attn_f.at[idx].set(a2),
                    jnp.zeros_like(rad).at[idx].set(r2),
                    jnp.zeros((n,), bool).at[idx].set(al2), s2)

        sel = (n_live <= p).astype(jnp.int32)
        o, dd, a, r_delta, al, s_delta = lax.switch(
            sel, [full_branch, prefix_branch], org, d, attn, offset)
        # deltas: live lanes enter a stage with rad == 0 (radiance only
        # accrues on the terminating miss), so adding is exact
        return o, dd, a, rad + r_delta, al, segments + s_delta

    cuts = [b for b, _ in compact_plan]
    div = dict(compact_plan)
    starts = [0] + cuts
    ends = cuts + [max_bounces]
    for b0, b1 in zip(starts, ends):
        if b1 <= b0:
            continue
        if b0 in div:
            org, d, attn, rad, alive, segments = compact_run(
                b0, b1, div[b0], org, d, attn, rad, alive, segments, offset)
        else:
            for bounce in range(b0, b1):
                org, d, attn, rad, alive, segments = bounce_step(
                    bounce, org, d, attn, rad, alive, segments, offset)
    return rad, segments


TILE = 32  # pixels per side of an image tile in tiled ray order


def make_pass_fn(camera: Camera, background: Callable, width: int, height: int,
                 spp: int, max_bounces: int, dtype=jnp.float32, intersect_fn=None,
                 dynamic_rows: bool = False, backend: str | None = None,
                 tiled: bool | None = None, mesh=None,
                 band_tile_rows: int | None = None, interpret: bool = False):
    """Build pass_fn(scene, pass_idx[, row_ids]) -> (radiance sums, segments).

    With dynamic_rows=True the pass_fn takes a traced (R,) int32 array of
    global row indices and returns (R, W, 3) sums — this is the unit of
    image-space sharding for `shard_map` (the tile analog, integrator.ml:132).

    tiled (default: on with the kernel tier): trace rays in 32x32-image-tile
    order so each kernel block holds spatially compact rays — dead paths
    cluster (whole sky tiles die at bounce 0) and the kernel's per-block
    early exit fires. The reference's Tile.split work decomposition
    (tile.ml:28-39) reborn as a SIMD-coherence layout.

    band_tile_rows (tiled only): return band_pass_fn(scene, pass_idx,
    tile_row0[, mesh_consts]) -> ((band_tile_rows*TILE, W, 3), segs), a
    band of tile-rows starting at TRACED tile-row index tile_row0 — the
    unit of image-space sharding for the TILED pass, so multi-device runs
    the same layout as one device (rows past the image bottom are dead
    lanes contributing zero).
    """
    sampler = Sampler(2 + 2 * max_bounces)
    xs = np.arange(width)
    xf32 = xs.astype(np.float32)
    inv_w = np.float32(1.0 / width)
    inv_h = np.float32(1.0 / height)
    backend = resolve_backend(backend)
    if tiled is None:
        tiled = not dynamic_rows and backend == "triton"

    def trace_rays(scene, dirs, offset, alive0, mesh_consts):
        return trace(scene, sampler, jnp.zeros_like(dirs), dirs, offset,
                     max_bounces, background, intersect_fn, backend,
                     alive0=alive0, mesh=mesh, mesh_consts=mesh_consts,
                     interpret=interpret)

    if tiled:
        hp = -(-height // TILE) * TILE
        wp = -(-width // TILE) * TILE
        tyn, txn = hp // TILE, wp // TILE
        ty, tx, iy, ix = np.meshgrid(np.arange(tyn), np.arange(txn),
                                     np.arange(TILE), np.arange(TILE),
                                     indexing="ij")
        y_ord = (ty * TILE + iy).reshape(-1)
        x_ord = (tx * TILE + ix).reshape(-1)
        valid_ord = (y_ord < height) & (x_ord < width)
        y_c = np.minimum(y_ord, height - 1)
        x_c = np.minimum(x_ord, width - 1)
        pix_ord = (y_c * width + x_c).astype(np.uint32)

        def untile(rad_flat):
            """(tyn*txn*TILE*TILE, 3) tile-major -> (H, W, 3)."""
            img = rad_flat.reshape(tyn, txn, TILE, TILE, 3)
            img = jnp.transpose(img, (0, 2, 1, 3, 4)).reshape(hp, wp, 3)
            return img[:height, :width]

        if band_tile_rows is not None:
            bt = band_tile_rows
            tyb, txb, iyb, ixb = np.meshgrid(
                np.arange(bt), np.arange(txn), np.arange(TILE),
                np.arange(TILE), indexing="ij")
            y_loc = (tyb * TILE + iyb).reshape(-1).astype(np.int32)
            x_ord_b = (txb * TILE + ixb).reshape(-1)
            x_valid = x_ord_b < width
            x_cb = np.minimum(x_ord_b, width - 1)

            def band_pass_fn(scene: SphereScene, pass_idx, tile_row0,
                             mesh_consts=None):
                pass_idx = jnp.asarray(pass_idx)
                lead = pass_idx.shape
                y_glob = (jnp.asarray(tile_row0, jnp.int32) * TILE
                          + jnp.asarray(y_loc))
                valid = (y_glob < height) & jnp.asarray(x_valid)
                y_cb = jnp.minimum(y_glob, height - 1)
                pix = (y_cb.astype(jnp.uint32) * np.uint32(width)
                       + jnp.asarray(x_cb, jnp.uint32))
                poff = (pass_idx.astype(jnp.uint32)
                        * np.uint32(spp)).reshape(lead + (1,))
                offset = pix[None] + poff
                dx = sampler.get(offset, 0)
                dy = sampler.get(offset, 1)
                cx = (jnp.asarray(x_cb, jnp.float32) + dx) * inv_w
                cy = 1.0 - (y_cb.astype(jnp.float32) + dy) * inv_h
                dirs = camera.ray_dirs(cx, cy, dtype).reshape(-1, 3)
                alive0 = jnp.broadcast_to(valid, offset.shape).reshape(-1)
                rad, segs = trace_rays(scene, dirs, offset.reshape(-1),
                                       alive0, mesh_consts)
                rad = rad.reshape(lead + (bt * txn * TILE * TILE, 3))
                if lead:
                    rad = jnp.sum(rad, axis=0)
                img = rad.reshape(bt, txn, TILE, TILE, 3)
                img = jnp.transpose(img, (0, 2, 1, 3, 4)) \
                    .reshape(bt * TILE, wp, 3)
                return img[:, :width], segs

            return band_pass_fn

        def tiled_pass_fn(scene: SphereScene, pass_idx, row_ids=None,
                          mesh_consts=None, raw=False):
            """raw=True: return radiance in flat tile-major order (the trace
            layout) so a pass loop can accumulate across passes without a
            per-pass untile transpose — callers untile the SUM once
            (tiled_pass_fn.untile)."""
            pass_idx = jnp.asarray(pass_idx)
            lead = pass_idx.shape
            poff = (pass_idx.astype(jnp.uint32) * np.uint32(spp)).reshape(
                lead + (1,))
            offset = jnp.asarray(pix_ord)[None] + poff  # (lead..., Np)
            dx = sampler.get(offset, 0)
            dy = sampler.get(offset, 1)
            cx = (jnp.asarray(x_c, jnp.float32) + dx) * inv_w
            cy = 1.0 - (jnp.asarray(y_c, jnp.float32) + dy) * inv_h
            dirs = camera.ray_dirs(cx, cy, dtype).reshape(-1, 3)
            alive0 = jnp.broadcast_to(jnp.asarray(valid_ord),
                                      offset.shape).reshape(-1)
            rad, segs = trace_rays(scene, dirs, offset.reshape(-1), alive0,
                                   mesh_consts)
            rad = rad.reshape(lead + (tyn * txn * TILE * TILE, 3))
            if lead:
                rad = jnp.sum(rad, axis=0)
            return (rad if raw else untile(rad)), segs

        tiled_pass_fn.untile = untile
        tiled_pass_fn.raw_shape = (tyn * txn * TILE * TILE, 3)
        return tiled_pass_fn

    def pass_fn(scene: SphereScene, pass_idx, row_ids=None,
                mesh_consts=None):
        """pass_idx may be a scalar or a (pb,) vector of pass indices — a
        vector traces all those passes as one fused wavefront and returns
        their summed radiance."""
        if row_ids is None:
            row_ids = jnp.arange(height, dtype=jnp.int32)
        rows = row_ids.shape[0]
        pass_idx = jnp.asarray(pass_idx)
        lead = pass_idx.shape  # () or (pb,)
        # offset = y*W + x + pass*spp (integrator.ml:98)
        poff = (pass_idx.astype(jnp.uint32) * np.uint32(spp)).reshape(lead + (1, 1))
        offset = (row_ids[:, None].astype(jnp.uint32) * np.uint32(width)
                  + jnp.asarray(xs, jnp.uint32)[None, :]) + poff
        dx = sampler.get(offset, 0)
        dy = sampler.get(offset, 1)
        cx = (xf32[None, :] + dx) * inv_w
        cy = 1.0 - (row_ids[:, None].astype(jnp.float32) + dy) * inv_h
        dirs = camera.ray_dirs(cx, cy, dtype).reshape(-1, 3)
        rad, segs = trace_rays(scene, dirs, offset.reshape(-1), None,
                               mesh_consts)
        rad = rad.reshape(lead + (rows, width, 3))
        if lead:
            rad = jnp.sum(rad, axis=0)
        return rad, segs

    if not dynamic_rows:
        return lambda scene, pass_idx, mesh_consts=None: \
            pass_fn(scene, pass_idx, None, mesh_consts)
    return pass_fn


def make_render_fn(camera: Camera, background: Callable, width: int, height: int,
                   spp: int, max_bounces: int, dtype=jnp.float32,
                   filter_order: int = 5, filter_radius: int = 1,
                   intersect_fn=None, passes_per_batch: int = 1,
                   backend: str | None = None, mesh=None,
                   interpret: bool = False):
    """Build render(scene) -> (image (H,W,3), total segments), one jitted
    program: a `lax.scan` over the spp passes, then the film filter.

    passes_per_batch > 1 traces that many passes as one fused wavefront per
    scan step (it must divide spp; otherwise 1 is used). The ray order
    follows the tier, as in make_pass_fn.
    """
    pass_fn = make_pass_fn(camera, background, width, height, spp, max_bounces,
                           dtype, intersect_fn, backend=backend, mesh=mesh,
                           interpret=interpret)
    kern2d = film.binomial_kernel_2d(filter_order, filter_radius)
    pb = passes_per_batch if passes_per_batch >= 1 and \
        spp % passes_per_batch == 0 else 1
    steps = spp // pb

    # tiled pass_fns expose a raw (flat tile-major) output + an untile
    # closure: accumulate the film sum in that layout across the scan and
    # untile ONCE at the end instead of paying a per-pass transpose
    untile = getattr(pass_fn, "untile", None)

    @jax.jit
    def render_impl(scene: SphereScene, mesh_consts):
        def body(sums, p):
            kw = {"raw": True} if untile is not None else {}
            s, g = pass_fn(scene, p if pb > 1 else p[0],
                           mesh_consts=mesh_consts, **kw)
            return sums + s, g

        init = (jnp.zeros(pass_fn.raw_shape, dtype) if untile is not None
                else jnp.zeros((height, width, 3), dtype))
        sums, segs = lax.scan(body, init, jnp.arange(spp).reshape(steps, pb))
        if untile is not None:
            sums = untile(sums)
        img = film.finalize(film.apply_filter(sums, kern2d, dtype), spp)
        return img, jnp.sum(segs)

    # mesh device arrays ride as jit ARGUMENTS (not closure constants,
    # which multiply XLA compile time — see MeshBVH.device_consts)
    consts = mesh.device_consts() if mesh is not None else None

    def run(scene):
        return render_impl(scene, consts)

    return run


def render_with_progress(camera, background, scene, width, height, spp,
                         max_bounces, dtype=jnp.float32, progress=None,
                         intersect_fn=None, filter_order=5, filter_radius=1,
                         backend=None, interpret: bool = False):
    """Host-driven pass loop (enables the reference-style progress bar;
    render_command.ml:83-104). Returns (image np.ndarray, segments int)."""
    pass_fn = jax.jit(make_pass_fn(camera, background, width, height, spp,
                                   max_bounces, dtype, intersect_fn,
                                   backend=backend, interpret=interpret))
    kern2d = film.binomial_kernel_2d(filter_order, filter_radius)
    sums = jnp.zeros((height, width, 3), dtype)
    seg_acc = jnp.zeros((), jnp.int32)
    # the bar advances every 8 passes: a host sync per pass would drain
    # the dispatch queue between passes, and the reference throttles its
    # redraws to >= 0.2 s anyway (render_command.ml:85-104). Segment
    # counts accumulate on the device.
    batch = 8
    done = 0
    for p in range(spp):
        s, segs = pass_fn(scene, jnp.int32(p))
        sums = sums + s
        seg_acc = seg_acc + segs
        if (p + 1) % batch == 0 or p + 1 == spp:
            jax.block_until_ready(sums)
            if progress is not None:
                progress(width * height * (p + 1 - done))
                done = p + 1
    img = film.finalize(film.apply_filter(sums, kern2d, dtype), spp)
    return np.asarray(img), int(jax.device_get(seg_acc))
