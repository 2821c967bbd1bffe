"""Progressive photon mapping on the device.

Reimplements the reference's `Progressive_photon_map`
(`progressive-photon-map/src/progressive_photon_map.ml`) with wavefront
passes over the same intersection machinery as the path tracer:

- photon pass: one wavefront over the photon budget; light emission
  (point-sphere / spot-disk, ppm.ml:59-111), per-bounce dims (2+2b, 3+2b),
  diffuse deposits + Russian roulette by Color.max_coord (ppm.ml:218-257).
  Deposits land in static per-bounce slots — no scatter.
- gather structure: the reference reuses its BVH as a point-radius index
  (ppm.ml:163-278); the XLA tier's equivalent is a **hash grid** with cell
  size = current radius, built by one device sort per iteration; neighbor
  query = a per-lane cursor over the 27 cells' photon lists. Hash
  collisions only add candidates — the exact distance + normal tests
  filter them. The kernel tier instead sorts photons into Morton-ordered
  chunks with exact boxes (ops/photon_chunks.py) gathered by the
  Pallas-Triton kernel in ops/pallas/gather_kernel.py.
- eye pass: wavefront over pixels; specular chains carry beta; at the first
  diffuse hit, cone-filter gather w = 1 - d/(k r), k=1, normalizer 1-2/(3k),
  normal agreement dot > 1e-3 (ppm.ml:319-371).
- radius schedule r^2(i) = init * (1/i) * prod_{k<i} (k+alpha)/k with
  init = ((bbox extent sum)/3 / ((W+H)/2))^2 (ppm.ml:296-301, 391-400).
- the averaged image (sum/n)^(1/2.2) is written after EVERY iteration
  (ppm.ml:406-450) — a killed run keeps its latest estimate, and
  checkpoint/resume is exact because all sampling is positional in
  (iteration, offset).

Sampler bookkeeping parity: photon sampler D = 2+2*max_bounces with offset
i + iter*photon_count; eye sampler D = 2+max_bounces (one dim per bounce —
eye paths stop at the first diffuse) with offset pixel + iter*W*H
(ppm.ml:402-447). PPM uses gamma 1/2.2, not the path tracer's sqrt.
"""

from __future__ import annotations

import functools
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import jax
import jax.numpy as jnp

from .camera import Camera
from .integrator import make_intersector, resolve_backend
from .ops import quat as quat_ops
from .ops import shading, vec
from .ops.lds import Sampler
from .scene import Scene

_SPOT_ANGLE = 0.5 * 45.0 * math.pi / 180.0
_SPOT_DISK_RADIUS = math.atan(_SPOT_ANGLE)  # ppm.ml:95-96 (as written there)


@dataclass
class Light:
    kind: str  # "point" | "spot"
    position: np.ndarray  # camera-space
    color: np.ndarray  # power-scaled color
    quat: np.ndarray = None  # spot: rotation of shader space (normal -> +z)

    @staticmethod
    def point(position, power, color=(1.0, 1.0, 1.0)) -> "Light":
        return Light("point", np.asarray(position, np.float64),
                     np.asarray(color, np.float64) * power)

    @staticmethod
    def spot(position, direction, power, color=(1.0, 1.0, 1.0)) -> "Light":
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        # Shader_space.create quaternion (shader_space.ml:11-23), host-side
        x, y, z = d
        if z > 1.0 - 1e-9:
            q = np.array([1.0, 0.0, 0.0, 0.0])
        elif z < 1e-9 - 1.0:
            q = np.array([0.0, 0.0, 1.0, 0.0])
        else:
            q = np.array([1.0 + z, y, -x, 0.0])
            q = q / np.linalg.norm(q)
        return Light("spot", np.asarray(position, np.float64),
                     np.asarray(color, np.float64) * power, q)

    @property
    def power(self) -> float:
        return float(self.color.sum())


def light_photon_counts(lights: List[Light], photon_count: int):
    """Per-light photon budget: truncation semantics of ppm.ml:262-270."""
    total = sum(l.power for l in lights)
    counts, starts, off = [], [], 0
    for l in lights:
        c = int(photon_count * (l.power / total))
        starts.append(off)
        counts.append(c)
        off += c
    return counts, starts, off  # off = total photons actually traced


def _emit_rays(lights, counts, starts, lane_ids, u, v, dtype):
    """Vectorized light emission: per-lane light selection by index range."""
    n = lane_ids.shape[0]
    org = jnp.zeros((n, 3), dtype)
    d = jnp.zeros((n, 3), dtype)
    flux = jnp.zeros((n, 3), dtype)
    for l, c, s in zip(lights, counts, starts):
        mask = (lane_ids >= s) & (lane_ids < s + c)
        if l.kind == "point":
            # uniform sphere (ppm.ml:70-84)
            theta = 2.0 * np.float32(np.pi) * u
            phi = jnp.arccos(1.0 - 2.0 * v)
            sp = jnp.sin(phi)
            dl = vec.v3(sp * jnp.cos(theta), sp * jnp.sin(theta), jnp.cos(phi))
            ol = jnp.broadcast_to(jnp.asarray(l.position, dtype), (n, 3))
        else:
            # spot disk-cone (ppm.ml:95-110): local (r cos, r sin, 1),
            # through Shader_space.world_ray (origin offset 1e-3*dir)
            r = np.float32(_SPOT_DISK_RADIUS) * jnp.sqrt(u)
            theta = v * 2.0 * np.float32(np.pi)
            local = vec.v3(r * jnp.cos(theta), r * jnp.sin(theta),
                           jnp.ones_like(u))
            q = jnp.broadcast_to(jnp.asarray(l.quat, dtype), (n, 4))
            dl = quat_ops.rotate_inv(q, local)
            ol = jnp.asarray(l.position, dtype) + np.float32(1e-3) * dl
        fl = jnp.broadcast_to(jnp.asarray(l.color, dtype), (n, 3))
        org = vec.where3(mask, ol, org)
        d = vec.where3(mask, dl, d)
        flux = vec.where3(mask, fl, flux)
    return org, d, flux


def make_photon_pass(scene: Scene, lights, photon_count: int, max_bounces: int,
                     backend: str, dtype=jnp.float32, mesh=None,
                     lanes_per_call: int = 131072, devices=None,
                     interpret: bool = False):
    """Build trace_photons(offset_base) -> (pos, normal, flux, valid)
    deposit arrays of shape (lanes*max_bounces, .). Large photon budgets are
    traced in host-level chunks of lanes_per_call lanes, which bounds each
    call's working set; sampling is positional so chunking is invisible.

    devices: when more than one, chunks round-robin across them (the
    reference's photon loop is serial, progressive_photon_map.ml:259-277;
    here the immutable scene broadcasts and chunk deposits concatenate,
    bit-identically to single-device because sampling is positional)."""
    sampler = Sampler(2 + 2 * max_bounces)
    counts, starts, total = light_photon_counts(lights, photon_count)
    lanes = -(-total // 1024) * 1024
    n_dev = len(devices) if devices else 1
    chunk = min(lanes, lanes_per_call)
    if n_dev > 1:  # split so every device gets work
        per_dev = -(-lanes // n_dev)
        chunk = min(chunk, -(-per_dev // 1024) * 1024)
    n_chunks = -(-lanes // chunk)
    # mesh AND scene arrays ride as jit arguments, not closure constants
    # (see MeshBVH.device_consts): lowering a closed-over DEVICE array into
    # an MLIR constant copies it to the host and embeds it in the program,
    # which multiplies compile time. The path tracer threads `scene` as a
    # traced argument for the same reason.
    consts = mesh.device_consts() if mesh is not None else None

    def trace_chunk_body(offset_base, lane_base, mesh_consts, scene_t):
        hit_setup = make_intersector(scene_t, backend, mesh=mesh,
                                     interpret=interpret)
        # iota INSIDE the trace: a closed-over device iota is an MLIR
        # constant too
        lane_ids = jnp.arange(chunk, dtype=jnp.int32) + lane_base
        offs = lane_ids.astype(jnp.uint32) + offset_base.astype(jnp.uint32)
        u0 = sampler.get(offs, 0)
        v0 = sampler.get(offs, 1)
        org, d, flux = _emit_rays(lights, counts, starts, lane_ids, u0, v0,
                                  dtype)
        alive = lane_ids < total

        def bounce_body(carry, b):
            org, d, flux, alive = carry
            # ray segments actually traced this bounce (dead lanes are
            # not rays) — the reference's
            # photon loop bounces exactly this many times, ppm.ml:218-257
            segs_b = jnp.sum(alive.astype(jnp.int32))
            u = sampler.get_dyn(offs, 2 + 2 * b)
            v = sampler.get_dyn(offs, 3 + 2 * b)
            h = hit_setup(org, d, alive, mesh_consts)
            hit = h["hit"] & alive
            q = shading.shader_quat(h["normal"])
            omega_i = quat_ops.rotate(q, -d)
            wi_z = omega_i[..., 2]
            albedo = h["albedo"]
            is_diff = h["mat_kind"] == 0
            is_met = h["mat_kind"] == 1

            # diffuse deposit (flux *= albedo first, ppm.ml:240-242)
            f_dep = flux * albedo
            dep = hit & is_diff

            # continuation
            # metal (material.ml:28-44)
            wo_met = shading.reflect_local(omega_i)
            met_ok = wo_met[..., 2] > 0.0
            tint = albedo + (1.0 - albedo) * ((1.0 - wi_z) ** 5)[..., None]
            # dielectric
            ci = jnp.clip(wi_z, 0.0, 1.0)
            si = jnp.sqrt(1.0 - ci * ci)
            ratio = jnp.where(h["hit_front"], h["ior_inv"], h["ior"])
            refl = (ratio * si > 1.0) | (shading.schlick(ci, ratio) > u)
            wo_die = vec.where3(refl, wo_met,
                                shading.refract_local(omega_i, ratio))
            # diffuse Russian roulette (ppm.ml:243-250)
            cmax = jnp.max(albedo, axis=-1)
            rr = u <= cmax
            cm_inv = 1.0 / cmax
            wo_dif = shading.cosine_hemisphere(u * cm_inv, v)
            f_dif = f_dep * cm_inv[..., None]

            wo = vec.where3(is_diff, wo_dif, vec.where3(is_met, wo_met, wo_die))
            f_new = vec.where3(is_diff, f_dif,
                               vec.where3(is_met, flux * tint, flux))
            ok = jnp.where(is_diff, rr, jnp.where(is_met, met_ok, True))

            dir_world = quat_ops.rotate_inv(q, wo)
            new_org = shading.world_ray(h["point"], dir_world)
            alive = hit & ok
            org = vec.where3(alive, new_org, org)
            d = vec.where3(alive, dir_world, d)
            flux = jnp.where(alive[..., None], f_new, flux)
            return (org, d, flux, alive), (h["point"], h["normal"], f_dep,
                                           dep, segs_b)

        _, (dep_pos, dep_nrm, dep_flux, dep_ok, segs_pb) = jax.lax.scan(
            bounce_body, (org, d, flux, alive),
            jnp.arange(max_bounces, dtype=jnp.int32))
        # keep the (bounce, lane) axes separate: chunked calls concatenate
        # on the LANE axis so the flattened deposit order is identical to
        # an unchunked call (bit-equal photon maps however work is split)
        return dep_pos, dep_nrm, dep_flux, dep_ok, jnp.sum(segs_pb)

    trace_chunk = jax.jit(trace_chunk_body)
    dep_rows = lanes * max_bounces

    def flatten(o):
        # ignores trailing non-deposit outputs (the segment counter)
        return tuple(x.reshape(-1, 3) if x.ndim == 3 else x.reshape(-1)
                     for x in o[:4])

    if n_chunks == 1:
        def one_chunk(offset_base):
            out = trace_chunk(offset_base, jnp.int32(0), consts, scene)
            # device scalar list, fetched lazily by telemetry/bench
            one_chunk.last_segments = [out[4]]
            return flatten(out)
        one_chunk._trace_chunk = trace_chunk  # AOT phase diagnostics
        one_chunk.sharded = lambda offset_base: [one_chunk(offset_base)]
        one_chunk.body, one_chunk.flatten = trace_chunk_body, flatten
        one_chunk.chunk, one_chunk.n_chunks = chunk, n_chunks
        return one_chunk, total, dep_rows

    if n_dev > 1:
        # broadcast the immutable scene/mesh once per device (the
        # reference shares them via shared memory across domains)
        consts_dev = [jax.device_put(consts, d) for d in devices]
        scene_dev = [jax.device_put(scene, d) for d in devices]
    else:
        consts_dev = [consts]
        scene_dev = [scene]

    def _dispatch_chunks(offset_base):
        """Yield (device_index, trace_chunk output) for every chunk — the
        single dispatch body shared by both aggregation modes."""
        for ci in range(n_chunks):
            di = ci % n_dev
            base = jnp.int32(ci * chunk)
            ob = jnp.uint32(offset_base)
            if n_dev > 1:
                base = jax.device_put(base, devices[di])
                ob = jax.device_put(ob, devices[di])
            yield di, trace_chunk(ob, base, consts_dev[di], scene_dev[di])

    def trace_photons(offset_base):
        outs = [o for _, o in _dispatch_chunks(offset_base)]
        dev0 = jax.devices()[0]
        # device scalars, NOT synced here (a host pull would stall the
        # photon->grid->eye dispatch chain); consumers sum lazily
        trace_photons.last_segments = [o[4] for o in outs]
        cat = tuple(jnp.concatenate(
            [jax.device_put(o[k], dev0) for o in outs], axis=1)[:, :lanes]
            for k in range(4))
        return flatten(cat)

    def trace_photons_sharded(offset_base):
        """Per-device deposits: each device KEEPS its own chunks' photons
        (no gather to device 0), so the photon map's memory footprint per
        device scales as 1/n_dev — `-photon-count` can grow with the mesh
        size. Padding lanes past `total` carry dep_ok=False, so no trim is
        needed; the gather masks them."""
        outs = [[] for _ in range(n_dev)]
        segs = []
        for di, o in _dispatch_chunks(offset_base):
            outs[di].append(o)
            segs.append(o[4])
        trace_photons.last_segments = segs
        per_dev = []
        for chunks_out in outs:
            if not chunks_out:
                continue
            cat = tuple(jnp.concatenate([o[k] for o in chunks_out], axis=1)
                        for k in range(4))
            per_dev.append(flatten(cat))
        return per_dev

    trace_photons._trace_chunk = trace_chunk  # AOT phase diagnostics
    trace_photons.sharded = trace_photons_sharded
    trace_photons.body, trace_photons.flatten = trace_chunk_body, flatten
    trace_photons.chunk, trace_photons.n_chunks = chunk, n_chunks
    return trace_photons, total, dep_rows


# --- hash grid ---

_HX = np.int32(73856093)
_HY = np.int32(19349663)
_HZ = np.int32(83492791)


def _cell_hash(ix, iy, iz, m):
    h = (ix * _HX) ^ (iy * _HY) ^ (iz * _HZ)
    return (h & jnp.int32(0x7FFFFFFF)) % jnp.int32(m)


def grid_m_for(photon_count: int, n_dev: int = 1) -> int:
    """Hash-bucket count sized from the PER-DEVICE photon count: the
    smallest power of two >= 2x photons (clamped to [2^17, 2^24]) keeps
    the mean bucket load ~constant as -photon-count grows — the
    reference accepts arbitrary photon counts
    (progressive_photon_map.ml:163-278) and its BVH gather scales with
    photon density, not a fixed table size.

    n_dev > 1 (sharded/ring photon map): each device's sub-grid indexes
    only ~1/n_dev of the photons, so the table shrinks with the mesh and
    -photon-count can grow 8x at constant per-chip table memory. The cap
    costs two int32 tables = 128 MiB of device memory at 2^24, reached
    only past ~8M photons/device where the deposit arrays (~40 B/deposit)
    dominate."""
    per_dev = -(-photon_count // max(1, n_dev))
    m = 1 << 17
    while m < 2 * per_dev and m < (1 << 24):
        m *= 2
    return m


@functools.partial(jax.jit, static_argnames=("m",))
def build_photon_grid(pos, valid, radius, m=1 << 17):
    """Sort photons by hash bucket; returns (order, start, count).

    Bucket boundaries come from bincount (one scatter-add) + exclusive
    cumsum rather than two m-query searchsorted calls into the sorted keys.
    """
    inv_r = 1.0 / radius
    ix = jnp.floor(pos[:, 0] * inv_r).astype(jnp.int32)
    iy = jnp.floor(pos[:, 1] * inv_r).astype(jnp.int32)
    iz = jnp.floor(pos[:, 2] * inv_r).astype(jnp.int32)
    key = jnp.where(valid, _cell_hash(ix, iy, iz, m), jnp.int32(m))
    n = pos.shape[0]
    keys_sorted, order = jax.lax.sort_key_val(key, jnp.arange(n, dtype=jnp.int32))
    count = jnp.bincount(key, length=m + 1)[:m].astype(jnp.int32)
    start = (jnp.cumsum(count) - count).astype(jnp.int32)
    return order, start, count


NEIGHBOR_OFFSETS = np.array(
    [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
     for z in (-1, 0, 1)], np.int32)


def _hash_gather_chunk(args, dep_lanes):
    """Per-lane dynamic cursor over the 27 neighbor cells' photon lists:
    total iterations per lockstep chunk = its own worst lane's actual
    photon count (plus 27 cell steps) — no fixed worst-case cap, so a
    caustic-dense cell doesn't tax the whole image, and inactive lanes
    cost nothing."""
    (point, normal, active, s_tab, c_tab), (radius, order, pos, nrm,
                                            flux, dep_valid) = args
    inv_r = 1.0 / radius
    r2 = radius * radius

    def cond(state):
        ci = state[0]
        return jnp.any(ci < 27)

    def body(state):
        ci, k, acc = state
        cic = jnp.minimum(ci, 26)
        cur_s = jnp.take_along_axis(s_tab, cic[:, None], 1)[:, 0]
        cur_c = jnp.take_along_axis(c_tab, cic[:, None], 1)[:, 0]
        in_cell = (ci < 27) & (k < cur_c)
        j = jnp.minimum(cur_s + k, dep_lanes - 1)
        pj = order[j]
        ok = in_cell & dep_valid[pj]
        pp = pos[pj]
        dist2 = vec.quadrance(point - pp)
        ok &= dist2 < r2
        ok &= vec.dot(nrm[pj], normal) > 1e-3
        w = 1.0 - jnp.sqrt(dist2) * inv_r  # cone filter k=1
        acc = acc + jnp.where(ok[..., None], w[..., None] * flux[pj], 0.0)
        k1 = k + 1
        done_cell = ~in_cell
        ci = jnp.where(done_cell, ci + 1, ci)
        k = jnp.where(done_cell, 0, k1)
        return ci, k, acc

    ci0 = jnp.where(active, 0, 27).astype(jnp.int32)
    init = (ci0, jnp.zeros_like(ci0), jnp.zeros_like(point))
    _, _, acc = jax.lax.while_loop(cond, body, init)
    return acc

def hash_gather(point, normal, active, radius, grid, grid_m,
                dep_lanes, chunk=4096):
    """Load-balanced lockstep gather: each chunk's cost is its own worst
    lane, so lanes are SORTED by their total candidate-photon count
    before chunking — dense (caustic) lanes share chunks with each other
    instead of taxing every chunk with one worst lane. 3-6x on
    photon-dense iterations for pure-XLA effort."""
    order, start, count, pos, nrm, flux, dep_valid = grid
    n = point.shape[0]
    inv_r = 1.0 / radius
    cx = jnp.floor(point[:, 0] * inv_r).astype(jnp.int32)
    cy = jnp.floor(point[:, 1] * inv_r).astype(jnp.int32)
    cz = jnp.floor(point[:, 2] * inv_r).astype(jnp.int32)
    offs27 = jnp.asarray(NEIGHBOR_OFFSETS)
    hkeys = _cell_hash(cx[:, None] + offs27[None, :, 0],
                       cy[:, None] + offs27[None, :, 1],
                       cz[:, None] + offs27[None, :, 2], grid_m)
    s_tab = start[hkeys]  # (n, 27)
    c_tab = jnp.where(active[:, None], count[hkeys], 0)
    # Dedupe colliding buckets: two DIFFERENT neighbor cells can hash to
    # the same bucket, and walking that bucket twice double-counts every
    # photon in range (the distance test passes both times). Keep only
    # the first visit of each bucket per lane: stable-sort each lane's 27
    # keys, zero all-but-first of every equal run, scatter the mask back.
    # (Stability makes "first of run" = lowest original slot, identical to
    # the previous O(27^2) pairwise loop but ~6x fewer traced ops.)
    lane_k = jnp.broadcast_to(jnp.arange(27, dtype=jnp.int32), hkeys.shape)
    sk, sidx = jax.lax.sort_key_val(hkeys, lane_k, dimension=1)
    dup_sorted = jnp.concatenate(
        [jnp.zeros((hkeys.shape[0], 1), bool), sk[:, 1:] == sk[:, :-1]],
        axis=1)
    rows = jnp.arange(hkeys.shape[0], dtype=jnp.int32)[:, None]
    dup = jnp.zeros(hkeys.shape, bool).at[rows, sidx].set(dup_sorted)
    c_tab = jnp.where(dup, 0, c_tab)
    cost = jnp.sum(c_tab, axis=1)
    perm = jnp.argsort(jnp.where(active, cost, -1))
    inv_perm = jnp.zeros((n,), jnp.int32).at[perm].set(
        jnp.arange(n, dtype=jnp.int32))
    point_s, normal_s = point[perm], normal[perm]
    active_s = active[perm]
    s_s, c_s = s_tab[perm], c_tab[perm]

    chunk = min(chunk, -(-n // 1024) * 1024)  # never pad past the band
    pad = (-n) % chunk
    if pad:
        point_s = jnp.concatenate([point_s, jnp.zeros((pad, 3))])
        normal_s = jnp.concatenate([normal_s, jnp.zeros((pad, 3))])
        active_s = jnp.concatenate([active_s, jnp.zeros((pad,), bool)])
        s_s = jnp.concatenate([s_s, jnp.zeros((pad, 27), s_s.dtype)])
        c_s = jnp.concatenate([c_s, jnp.zeros((pad, 27), c_s.dtype)])
    nc = point_s.shape[0] // chunk
    rsh = lambda x: x.reshape(nc, chunk, *x.shape[1:])
    acc = jax.lax.map(
        lambda a: _hash_gather_chunk(
            (a, (radius, order, pos, nrm, flux, dep_valid)), dep_lanes),
        (rsh(point_s), rsh(normal_s), rsh(active_s), rsh(s_s), rsh(c_s)))
    return acc.reshape(-1, 3)[:n][inv_perm]


def scene_all_diffuse(scene, mesh=None) -> bool:
    """True when no valid primitive has a specular (metal/dielectric)
    material — then an eye path can never continue past its first hit."""
    mk = np.asarray(scene.mat_kind)[np.asarray(scene.valid)]
    if (mk != 0).any():
        return False
    if scene.tri_pack is not None and scene.tri_count > 0:
        tv = np.asarray(scene.tri_valid)
        from .scene import TRI_MAT
        if (np.asarray(scene.tri_pack)[tv, TRI_MAT.start] != 0).any():
            return False
    if mesh is not None and float(np.asarray(mesh.mat_row)[0]) != 0.0:
        return False
    return True


def make_eye_pass(camera: Camera, width: int, height: int,
                  max_bounces: int, photon_count: int, dep_lanes: int,
                  backend: str, grid_m: int = 1 << 17, dtype=jnp.float32,
                  mesh=None, band_rows: int = 64, use_kernel: bool = False,
                  eff_bounces: int = None, interpret: bool = False):
    """Build eye_pass(offset_base, radius, grid+deposits, row0) -> one
    `band_rows`-row band of a PPM iteration's contribution (scaled by
    1/photon_count).

    use_kernel: gather with the Pallas-Triton chunk kernel over a
    `build_photon_chunks` map instead of the XLA hash-grid walk; the
    intersector follows `backend`. interpret runs both kernels in Pallas
    interpret mode (CPU tests).

    eff_bounces: static cap on the specular-walk scan. For a scene with no
    specular materials every eye path terminates at its first hit (the
    walk only continues through Specular scatters, ppm.ml:330-343), so
    bounces past the first are provably dead lanes; the sampler keeps the
    max_bounces dimension count so the sample stream is unchanged."""
    sampler = Sampler(2 + max_bounces)
    eff_bounces = max_bounces if eff_bounces is None else eff_bounces
    n_pix = width * band_rows
    lanes = -(-n_pix // 1024) * 1024
    lane_ids = np.arange(lanes)
    xs = (lane_ids % width).astype(np.float32)
    ys_local = (lane_ids // width).astype(np.float32)
    inv_pc = np.float32(1.0 / photon_count)

    gather = functools.partial(hash_gather, grid_m=grid_m,
                               dep_lanes=dep_lanes)

    def gather_kernel(point, normal, active, radius, grid):
        """Pallas-Triton chunk-list gather (ops/pallas/gather_kernel.py):
        hits sorted by Morton key over their own bbox so each kernel block
        is spatially compact; each block walks the photon chunks whose
        exact boxes come within the radius of its hits. No grid-resolution
        limit — the density-adaptive answer to the reference's photon BVH
        point query (progressive_photon_map.ml:163-278)."""
        from .ops import photon_chunks as pc
        from .ops.pallas import gather_kernel as gk

        photons_t, cbox = grid
        perm = jnp.argsort(pc.morton_keys(point, active))
        # scatter-built inverse instead of a second argsort (perm is a
        # permutation so the scatter is exact)
        n_h = perm.shape[0]
        inv_perm = jnp.zeros((n_h,), jnp.int32).at[perm].set(
            jnp.arange(n_h, dtype=jnp.int32))
        flux = gk.gather_flux(point[perm], normal[perm], active[perm], cbox,
                              photons_t, radius, interpret=interpret)
        return flux[inv_perm]

    if use_kernel:
        gather = gather_kernel

    def eye_walk(offset_base, row0, mesh_consts, scene_t):
        # scene rides as a traced argument — closed-over device arrays
        # become MLIR constants (see make_photon_pass)
        hit_setup = make_intersector(scene_t, backend, mesh=mesh,
                                     interpret=interpret)
        # lane's global pixel = (row0 + lane//W) * W + lane%W
        pix = (row0.astype(jnp.uint32) * np.uint32(width)
               + jnp.asarray(lane_ids, jnp.uint32))
        offs = pix + offset_base.astype(jnp.uint32)
        dx = sampler.get(offs, 0)
        dy = sampler.get(offs, 1)
        # NOTE: cy is NOT flipped here; the reference flips y at write time
        # (ppm.ml:311-315,383-388)
        ys = row0.astype(jnp.float32) + jnp.asarray(ys_local)
        cx = (jnp.asarray(xs) + dx) * np.float32(1.0 / width)
        cy = (ys + dy) * np.float32(1.0 / height)
        d = camera.ray_dirs(cx, cy, dtype)
        org = jnp.zeros_like(d)
        beta = jnp.ones_like(d)
        alive = jnp.asarray(lane_ids < n_pix) & (
            (row0 + jnp.asarray(lane_ids // width, jnp.int32)) < height)
        # first-diffuse record: the specular walk only COLLECTS (point,
        # normal, beta*albedo) at each lane's first diffuse hit — the gather
        # runs ONCE after the scan over all lanes (each eye path gathers at
        # most once, ppm.ml:330-371, so running the neighbor walk per bounce
        # paid max_bounces x the lockstep loop overhead for nothing).
        fd_pt = jnp.zeros_like(d)
        fd_nrm = jnp.zeros_like(d)
        fd_beta = jnp.zeros_like(d)
        fd_ok = jnp.zeros(d.shape[:1], bool)

        def make_bounce_body(offs):
            def bounce_body(carry, b):
                org, d, beta, alive, fd_pt, fd_nrm, fd_beta, fd_ok = carry
                u = sampler.get_dyn(offs, 2 + b)  # one dim per eye bounce
                h = hit_setup(org, d, alive, mesh_consts)
                hit = h["hit"] & alive
                q = shading.shader_quat(h["normal"])
                omega_i = quat_ops.rotate(q, -d)
                wi_z = omega_i[..., 2]
                albedo = h["albedo"]
                is_diff = h["mat_kind"] == 0
                is_met = h["mat_kind"] == 1

                # diffuse: record and terminate (a lane reaches this once)
                take = hit & is_diff
                fd_pt = vec.where3(take, h["point"], fd_pt)
                fd_nrm = vec.where3(take, h["normal"], fd_nrm)
                fd_beta = vec.where3(take, beta * albedo, fd_beta)
                fd_ok = fd_ok | take

                # specular continuation
                wo_met = shading.reflect_local(omega_i)
                met_ok = wo_met[..., 2] > 0.0
                tint = albedo + (1.0 - albedo) * ((1.0 - wi_z) ** 5)[..., None]
                ci = jnp.clip(wi_z, 0.0, 1.0)
                si = jnp.sqrt(1.0 - ci * ci)
                ratio = jnp.where(h["hit_front"], h["ior_inv"], h["ior"])
                refl = (ratio * si > 1.0) | (shading.schlick(ci, ratio) > u)
                wo_die = vec.where3(refl, wo_met,
                                    shading.refract_local(omega_i, ratio))
                wo = vec.where3(is_met, wo_met, wo_die)
                beta_new = vec.where3(is_met, beta * tint, beta)
                ok = jnp.where(is_met, met_ok, ~is_diff)

                dir_world = quat_ops.rotate_inv(q, wo)
                new_org = shading.world_ray(h["point"], dir_world)
                alive = hit & ok
                org = vec.where3(alive, new_org, org)
                d = vec.where3(alive, dir_world, d)
                beta = jnp.where(alive[..., None], beta_new, beta)
                return (org, d, beta, alive,
                        fd_pt, fd_nrm, fd_beta, fd_ok), None
            return bounce_body

        carry = (org, d, beta, alive, fd_pt, fd_nrm, fd_beta, fd_ok)
        # Specular-walk lane compaction (the eye-pass analog of the path
        # tracer's mesh-walk ladder): most lanes record their first diffuse
        # at bounce 0 and die — the walk only continues through Specular
        # scatters (ppm.ml:330-343) — so bounces 1+ over the full band run
        # at low occupancy. After bounce 0 the live lanes are argsort-packed
        # to the front and bounces 1+ run inside a lax.switch branch whose
        # arrays are PHYSICALLY the branch's static prefix size (per-lane
        # results are unchanged, so the band output is bit-exact vs the
        # uncompacted walk).
        # Default: ladder only when the walk traverses a mesh BVH, the
        # case where a bounce is expensive enough to pay for the argsort
        # and switch. Neither benchmarked scene takes it (ganesha is
        # all-diffuse, so its walk is a single bounce); whether it pays on
        # the GPU is not measured. PATHTRACER_PPM_EYE_COMPACT=0/1 forces
        # either path.
        compact_env = os.environ.get("PATHTRACER_PPM_EYE_COMPACT", "")
        want = (mesh is not None) if compact_env not in ("0", "1") \
            else compact_env == "1"
        ladder = eff_bounces > 1 and lanes >= 8 * 1024 and want
        # bounce 0 runs INLINE (not as a scan iteration) on BOTH paths:
        # an inline bounce fuses with the camera-ray setup and XLA's fp
        # contraction choices there differ from the standalone scan-body
        # compilation, so ladder-on/-off only stay bit-identical if the
        # two programs share the bounce-0 structure (measured: inline-vs-
        # scan bounce 0 moved first-diffuse points by ~3e-5 on ~15% of
        # specular-continuation lanes)
        if eff_bounces == 1:
            carry, _ = make_bounce_body(offs)(carry, jnp.int32(0))
            return carry[4], carry[5], carry[6], carry[7]
        carry, _ = make_bounce_body(offs)(carry, jnp.int32(0))
        if not ladder:
            carry, _ = jax.lax.scan(
                make_bounce_body(offs), carry,
                jnp.arange(1, eff_bounces, dtype=jnp.int32))
            return carry[4], carry[5], carry[6], carry[7]
        org, d, beta, alive, fd_pt, fd_nrm, fd_beta, fd_ok = carry
        n_live = jnp.sum(alive.astype(jnp.int32))
        perm = jnp.argsort(jnp.where(alive, 0, 1).astype(jnp.int32))
        sizes, s = [lanes], lanes // 2
        while s >= 4 * 1024 and len(sizes) < 4:
            sizes.append(-(-s // 1024) * 1024)
            s //= 2

        def branch(p):
            def br(org_f, d_f, beta_f, offs_f):
                idx = perm[:p]
                c2 = (org_f[idx], d_f[idx], beta_f[idx], alive[idx],
                      jnp.zeros((p, 3), org_f.dtype),
                      jnp.zeros((p, 3), org_f.dtype),
                      jnp.zeros((p, 3), org_f.dtype),
                      jnp.zeros((p,), bool))
                c2, _ = jax.lax.scan(
                    make_bounce_body(offs_f[idx]), c2,
                    jnp.arange(1, eff_bounces, dtype=jnp.int32))
                pad = lanes - p
                if pad:
                    z3 = jnp.zeros((pad, 3), org_f.dtype)
                    return (jnp.concatenate([c2[4], z3]),
                            jnp.concatenate([c2[5], z3]),
                            jnp.concatenate([c2[6], z3]),
                            jnp.concatenate([c2[7],
                                             jnp.zeros((pad,), bool)]))
                return c2[4], c2[5], c2[6], c2[7]
            return br

        sel = sum((n_live <= p).astype(jnp.int32) for p in sizes[1:])
        p_pt, p_nrm, p_beta, p_ok = jax.lax.switch(
            sel, [branch(p) for p in sizes], org, d, beta, offs)
        # scatter the prefix records back over the bounce-0 records (a
        # lane writes its first-diffuse at most once, so the two never
        # overlap: p_ok lanes were alive after bounce 0, fd_ok ones dead)
        okc = p_ok[:, None]
        fd_pt = fd_pt.at[perm].set(jnp.where(okc, p_pt, fd_pt[perm]))
        fd_nrm = fd_nrm.at[perm].set(jnp.where(okc, p_nrm, fd_nrm[perm]))
        fd_beta = fd_beta.at[perm].set(jnp.where(okc, p_beta, fd_beta[perm]))
        fd_ok = fd_ok.at[perm].set(p_ok | fd_ok[perm])
        # barrier: the fd record VALUES are bit-identical to the
        # uncompacted walk's (tested), but without a boundary XLA is free
        # to contract walk-side multiplies into the downstream
        # gather/finish graph differently for the ladder program, which
        # broke band-placement bit-invariance at the ~4e-6 level
        return jax.lax.optimization_barrier(
            (fd_pt, fd_nrm, fd_beta, fd_ok))

    def finish(fd_beta, fd_ok, flux, radius):
        area = np.float32(np.pi) * radius * radius
        normalizer = np.float32(1.0 - 2.0 / 3.0)
        contrib = fd_beta * flux / (area * normalizer)
        result = vec.where3(fd_ok, contrib, jnp.zeros_like(contrib))
        return (result * inv_pc)[:n_pix].reshape(band_rows, width, 3)

    def eye_pass(offset_base, radius, grid, row0, mesh_consts, scene_t):
        fd_pt, fd_nrm, fd_beta, fd_ok = eye_walk(offset_base, row0,
                                                 mesh_consts, scene_t)
        flux = gather(fd_pt, fd_nrm, fd_ok, radius, grid)
        return finish(fd_beta, fd_ok, flux, radius)

    # sharded-photon-map pieces: the driver runs walk ONCE per band, then
    # gathers a partial flux against each device's sub-grid and sums the
    # partials in fixed device order (flux is additive over photons)
    eye_pass.walk = eye_walk
    eye_pass.finish = finish
    if use_kernel:
        eye_pass.make_gather = lambda dl: gather_kernel
    else:
        eye_pass.make_gather = lambda dl: functools.partial(
            hash_gather, grid_m=grid_m, dep_lanes=dl)
    return eye_pass


@dataclass
class PPMRenderer:
    """Iteration driver (Make(Scene).go, ppm.ml:420-450)."""

    scene: Scene
    camera: Camera
    lights: List[Light]
    width: int
    height: int
    iterations: int = 10
    photon_count: int = 75000
    alpha: float = 2.0 / 3.0
    max_bounces: int = 4
    backend: str = None  # "xla" | "triton" | None = by platform
    verbose: bool = True
    mesh: object = None
    bbox_override: tuple = None
    devices: list = None  # eye-pass bands fan out across these (default: all)
    phase_cb: Callable = None  # optional (name, value) hook at iteration
    # phase boundaries (photon_trace / grid_build / bands_dispatched /
    # stitch), for attributing wall time; None = no-op
    shard_photon_map: bool = False  # multi-device: each device keeps ONLY
    # its own photon chunks and builds a sub-grid over them, so the photon
    # map's memory per device scales 1/n_dev (-photon-count can grow with
    # the device count). Two layouts:
    #   True   — host-orchestrated: the eye walk runs once per band, a
    #            partial flux is gathered against every sub-grid, each band
    #            and gather a device call of its own;
    #   "ring" — one shard_map over a "pp" device mesh: each device walks
    #            its own image band and the sub-grids rotate around the
    #            ring with lax.ppermute, so the whole eye pass is one
    #            device program (parallel/ppm_ring.py).
    # Both are deterministic; the FP association differs from the
    # replicated map, so images match to ~1e-6, not bit-exactly.
    interpret: bool = False  # run the kernel tier in Pallas interpret mode

    def __post_init__(self):
        self.backend = resolve_backend(self.backend)
        if self.bbox_override is not None:
            lo, hi = self.bbox_override
        else:
            lo, hi = self.scene.bbox()
        a = float((hi - lo).sum()) / 3.0
        b = (self.width + self.height) / 2.0
        self.init_radius2 = (a / b) ** 2

    def radius(self, i: int) -> float:
        # shrink schedule (ppm.ml:391-400)
        assert i >= 1
        product = 1.0
        for k in range(1, i):
            product *= (k + self.alpha) / k
        return math.sqrt(product * self.init_radius2 / i)

    def render(self, output: str = None, checkpoint_cb=None,
               checkpoint_path: str = None):
        """Run the PPM iteration loop.

        checkpoint_path: if given, (img_sum, next_iteration) are saved there
        every iteration and the run RESUMES from that file when it exists.
        The reference only rewrites the averaged PNG each iteration
        (ppm.ml:449); true resume is exact here because every sample is a
        pure function of (iteration, offset) — no hidden RNG state.
        """
        from .ops.photon_chunks import build_photon_chunks

        if self.verbose:
            print(f"#max-bounces = {self.max_bounces}")
            print(f"#photons/iter = {self.photon_count}")
            print(f"#iterations = {self.iterations}")
            print("-----", flush=True)
        trace_photons, total, dep_lanes = make_photon_pass(
            self.scene, self.lights, self.photon_count, self.max_bounces,
            self.backend, mesh=self.mesh,
            devices=self.devices or jax.devices(), interpret=self.interpret)
        eye_passes = {}
        use_kernel = self.backend == "triton"

        eff_bounces = (1 if scene_all_diffuse(self.scene, self.mesh)
                       else self.max_bounces)

        _n_dev_grid = (len(self.devices or jax.devices())
                       if self.shard_photon_map else 1)
        grid_m = grid_m_for(self.photon_count, _n_dev_grid)

        def eye_pass_raw(band_rows, dep_rows):
            return make_eye_pass(
                self.camera, self.width, self.height, self.max_bounces,
                self.photon_count, dep_rows, self.backend, grid_m=grid_m,
                mesh=self.mesh, band_rows=band_rows, use_kernel=use_kernel,
                eff_bounces=eff_bounces, interpret=self.interpret)

        def get_eye_pass(band_rows):
            if band_rows not in eye_passes:
                raw = eye_pass_raw(band_rows, dep_lanes)
                eye_passes[band_rows] = (jax.jit(raw), raw)
            return eye_passes[band_rows]
        img_sum = np.zeros((self.height, self.width, 3), np.float64)
        start_iter = 0
        img_comp = None  # device-path Kahan compensation term
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if (ck["img_sum"].shape == img_sum.shape
                    and int(ck["photon_count"]) == self.photon_count
                    and float(ck["alpha"]) == self.alpha):
                img_sum = ck["img_sum"]
                start_iter = int(ck["next_iteration"])
                if self.verbose:
                    print(f"resuming from iteration {start_iter}", flush=True)
        consts_dev = scene_dev = None
        devices = self.devices or jax.devices()
        shard = bool(self.shard_photon_map) and len(devices) > 1
        ring = (self.shard_photon_map == "ring") and len(devices) > 1
        # Device-side film accumulation: when nothing on the host consumes
        # the running image every iteration (no per-iteration PNG rewrite,
        # no checkpoint file), the per-iteration device->host stitch pull
        # is pure waste — accumulate on device (Kahan-compensated f32: x64
        # is off, so the host path's f64 sum isn't representable on device;
        # compensation keeps the iteration-sum error far below the RMSE
        # budget) and pull once at the end. checkpoint_cb then receives the
        # DEVICE array.
        dev_accum = (output is None and checkpoint_path is None
                     and not self.verbose and len(devices) == 1
                     and not ring and not shard and start_iter == 0)
        if dev_accum:
            img_sum = jnp.zeros((self.height, self.width, 3), jnp.float32)
            img_comp = jnp.zeros_like(img_sum)

            @jax.jit
            def _accum_bands(s, c, *bands):
                band = jnp.concatenate(bands)[:self.height][::-1]
                y = band - c
                t = s + y
                return t, (t - s) - y
        shard_fns = {}  # band_rows -> (walk_jit, finish_jit)
        gather_jits = {}  # dep_lanes -> jitted partial-flux gather
        ring_env = {}  # jmesh + replicated consts + compiled ring passes
        ring_full = False
        if ring:
            from jax.sharding import NamedSharding, PartitionSpec

            from .parallel import ppm_ring as PR

            ring_env["jmesh"] = PR.make_ppm_mesh(devices)
            rep = NamedSharding(ring_env["jmesh"], PartitionSpec())
            _mc = (self.mesh.device_consts()
                   if self.mesh is not None else None)
            ring_env["consts"] = (jax.device_put(_mc, rep)
                                  if _mc is not None else None)
            ring_env["scene"] = jax.device_put(self.scene, rep)
            # at most one trace chunk per device -> the photon trace AND
            # the sub-grid build fuse into ONE shard_map program (devices
            # past the chunk count trace all-dead lanes); a full
            # iteration is then exactly two device programs with zero
            # host photon traffic. Larger budgets (>131k lanes/device)
            # fall back to host-orchestrated chunks + pad + stack.
            ring_full = trace_photons.n_chunks <= len(devices)
            if ring_full:
                def _ring_grid_build(pos, nrm, flux, ok, rr):
                    if use_kernel:
                        return build_photon_chunks(pos, nrm, flux, ok)
                    order, start, count = build_photon_grid(pos, ok, rr,
                                                            m=grid_m)
                    return (order, start, count, pos, nrm, flux, ok)

                ring_env["trace"] = PR.make_ring_photon_grid(
                    trace_photons.body, trace_photons.flatten,
                    trace_photons.chunk, ring_env["jmesh"],
                    _ring_grid_build)

        # --- fused single-device iteration -------------------------------
        # With the kernel tier, photon trace + chunk build + the WHOLE eye
        # pass as one full-height band (+ the film accumulate when nothing
        # on the host consumes the running image) compile into ONE
        # program: an iteration is one dispatch instead of a chain of six
        # (trace, chunk build, 3 eye bands, accumulate). The XLA tier keeps
        # the chain: its lockstep gather holds (lanes, 27) cell tables and
        # a lane sort per band, so it stays in 64-row bands (below).
        # Phase boundaries keep optimization barriers so per-phase fp
        # contraction — and hence the image — stays bit-identical to the
        # unfused program chain.
        fused = (len(devices) == 1 and not shard and not ring
                 and use_kernel and trace_photons.n_chunks == 1
                 and self.phase_cb is None)
        fused_fns = {}
        if fused:
            eye_raw_f = eye_pass_raw(self.height, dep_lanes)

            def _fused_body(offset_ph, offset_eye, rj, consts, scene_t):
                out = trace_photons.body(offset_ph, jnp.int32(0), consts,
                                         scene_t)
                dep = jax.lax.optimization_barrier(
                    trace_photons.flatten(out))
                grid = jax.lax.optimization_barrier(
                    build_photon_chunks(*dep))
                band = eye_raw_f(offset_eye, rj, grid, jnp.int32(0),
                                 consts, scene_t)
                n_ph = jnp.sum(dep[3].astype(jnp.int32))
                return band[:self.height][::-1], out[4], n_ph

            if dev_accum:
                @jax.jit
                def fused_iter(offset_ph, offset_eye, rj, s, c, consts,
                               scene_t):
                    band, segs, n_ph = _fused_body(
                        offset_ph, offset_eye, rj, consts, scene_t)
                    y = band - c
                    t = s + y
                    return t, (t - s) - y, segs, n_ph
            else:
                fused_iter = jax.jit(_fused_body)
            fused_fns["iter"] = fused_iter
            fused_fns["consts"] = (self.mesh.device_consts()
                                   if self.mesh is not None else None)

        def build_one_grid(pos, nrm, flux, ok, r):
            """Build one (sub-)grid over the given deposits, on whatever
            device holds them (jnp ops follow committed inputs)."""
            if use_kernel:
                return build_photon_chunks(pos, nrm, flux, ok)
            order, start, count = build_photon_grid(pos, ok, jnp.float32(r),
                                                    m=grid_m)
            return (order, start, count, pos, nrm, flux, ok)

        # Eye-pass band height. The ring gives each device one band. The
        # kernel tier's chunk lists grow with lanes x chunks, so bands cap
        # its working set at 256 rows. The XLA tier's lockstep gather
        # keeps (lanes, 27) cell tables and a lane sort per band; 64-row
        # power-of-two bands bound that and the number of compiled shapes.
        if ring:
            band_rows = -(-self.height // len(devices))
        elif use_kernel:
            band_rows = min(256, self.height)
        else:
            band_rows = 4
            while band_rows * 2 <= min(64, self.height):
                band_rows *= 2
            band_rows = min(band_rows, self.height)
        n_bands = -(-self.height // band_rows)

        # per-iteration (photon_segments, eye_segments) for the ray-rate
        # accounting. photon = list of lazy device scalars; eye is exact
        # only for all-diffuse scenes (one primary segment per pixel — the
        # walk never continues, ppm.ml:330-343), else None (specular walks
        # aren't instrumented).
        self.iter_segments = []
        for i in range(start_iter, self.iterations):
            t_iter = time.monotonic()
            r = self.radius(i + 1)
            if self.verbose:
                print(f"#iteration = {i}, radius = {r:.3f}", flush=True)
            if fused:
                args = (jnp.uint32(i * self.photon_count),
                        jnp.uint32(i * self.width * self.height),
                        jnp.float32(r))
                if dev_accum:
                    img_sum, img_comp, segs, n_ph = fused_fns["iter"](
                        *args, img_sum, img_comp, fused_fns["consts"],
                        self.scene)
                else:
                    band, segs, n_ph = fused_fns["iter"](
                        *args, fused_fns["consts"], self.scene)
                    img_sum += np.asarray(band, np.float64)
                trace_photons.last_segments = [segs]
                if self.verbose:
                    print(f"  photon map length = {int(n_ph)} "
                          f"({time.monotonic() - t_iter:.2f}s)", flush=True)
            else:
                if ring_full:
                    # photon trace + sub-grid build fused in one shard_map;
                    # the output is already the pp-stacked grid pytree
                    stacked = ring_env["trace"](
                        jnp.uint32(i * self.photon_count), jnp.float32(r),
                        ring_env["consts"], ring_env["scene"])
                    dep_rows_shard = trace_photons.chunk * self.max_bounces
                elif shard:
                    per_dev = trace_photons.sharded(
                        jnp.uint32(i * self.photon_count))
                else:
                    pos, nrm, flux, ok = trace_photons(
                        jnp.uint32(i * self.photon_count))
                if self.phase_cb is not None:
                    self.phase_cb("photon_trace",
                                  stacked if ring_full else
                                  per_dev if shard else (pos, nrm, flux, ok))
                if self.verbose:
                    # the length pull is a host sync — only pay it when the
                    # telemetry is actually printed (quiet production runs keep
                    # the photon->grid->eye chain one uninterrupted dispatch)
                    if ring_full:  # chunk planes / hash cell counts
                        n_photons = int(jnp.sum(stacked[0][:, 0] < 1e38)
                                        if use_kernel else stacked[2].sum())
                    elif shard:
                        n_photons = sum(int(o[3].sum()) for o in per_dev)
                    else:
                        n_photons = int(ok.sum())
                    print(f"  photon map length = {n_photons} "
                          f"({time.monotonic() - t_iter:.2f}s)", flush=True)
                if ring_full:
                    pass  # grids already built in-program
                elif shard:
                    per_dev, dep_rows_shard = PR.pad_deposits(
                        per_dev, len(devices), devices) if ring \
                        else (per_dev, None)
                    sub_grids = [build_one_grid(*o, r) for o in per_dev]
                else:
                    grid = build_one_grid(pos, nrm, flux, ok, r)
                if self.phase_cb is not None:
                    self.phase_cb("grid_build",
                                  stacked if ring_full else
                                  sub_grids if shard else grid)
                eye_fn = eye_raw = None
                if not ring:
                    eye_fn, eye_raw = get_eye_pass(band_rows)
                # fan the independent bands out across devices: the photon map is
                # replicated (device_put broadcast — the reference's shared
                # immutable tree), bands round-robin, results stitched on host.
                # This is the domainslib tile fan-out (integrator.ml:141-151)
                # for the photon mapper. With shard_photon_map each device keeps
                # its own sub-grid instead and bands gather a partial flux from
                # every device.
                if shard:
                    grids = [None] * len(devices)
                elif len(devices) > 1:
                    grids = [jax.device_put(grid, dev) for dev in devices]
                else:
                    grids = [grid]
                if consts_dev is None and not ring:
                    # iteration-invariant: broadcast once (the ring branch
                    # keeps its own replicated copies in ring_env and never
                    # reads consts_dev/scene_dev — building both would double
                    # the per-device footprint of the BVH table + scene)
                    mesh_consts = (self.mesh.device_consts()
                                   if self.mesh is not None else None)
                    if len(devices) > 1:
                        consts_dev = [jax.device_put(mesh_consts, dev)
                                      for dev in devices] \
                            if mesh_consts is not None else [None] * len(devices)
                        scene_dev = [jax.device_put(self.scene, dev)
                                     for dev in devices]
                    else:
                        consts_dev = [mesh_consts]
                        scene_dev = [self.scene]
                futures = []
                if ring:
                    key = (band_rows, dep_rows_shard)
                    if key not in ring_env:
                        ring_env[key] = PR.make_ring_eye_pass(
                            eye_pass_raw(band_rows, dep_rows_shard),
                            ring_env["jmesh"], band_rows)(dep_rows_shard)
                    if not ring_full:  # host-traced fallback: stack sub-grids
                        stacked = PR.stack_sharded_grids(sub_grids,
                                                         ring_env["jmesh"])
                    futures.append(ring_env[key](
                        jnp.uint32(i * self.width * self.height),
                        jnp.float32(r), stacked, ring_env["consts"],
                        ring_env["scene"]))
                elif shard:
                    if band_rows not in shard_fns:
                        shard_fns[band_rows] = (jax.jit(eye_raw.walk),
                                                jax.jit(eye_raw.finish))
                    walk_fn, finish_fn = shard_fns[band_rows]
                    sub_gathers = []
                    for g in sub_grids:
                        # hash-grid tuple: photon positions at slot 3; the
                        # kernel-tier gather ignores dep_lanes
                        dl = 0 if use_kernel else int(g[3].shape[0])
                        if dl not in gather_jits:
                            gather_jits[dl] = jax.jit(eye_raw.make_gather(dl))
                        sub_gathers.append(gather_jits[dl])
                    rj = jnp.float32(r)
                    for bi in range(n_bands):
                        dev = bi % len(devices)
                        put = lambda x: jax.device_put(x, devices[dev])
                        fd_pt, fd_nrm, fd_beta, fd_ok = walk_fn(
                            put(jnp.uint32(i * self.width * self.height)),
                            put(jnp.int32(bi * band_rows)),
                            consts_dev[dev], scene_dev[dev])
                        # partial flux per sub-grid, summed in FIXED sub-grid
                        # order (deterministic; association differs from the
                        # replicated map by FP reassociation only)
                        fsum = None
                        for g, gf in zip(sub_grids, sub_gathers):
                            gdev = next(iter(g[0].devices()))
                            part = gf(jax.device_put(fd_pt, gdev),
                                      jax.device_put(fd_nrm, gdev),
                                      jax.device_put(fd_ok, gdev),
                                      jax.device_put(rj, gdev), g)
                            part = jax.device_put(part, devices[dev])
                            fsum = part if fsum is None else fsum + part
                        futures.append(finish_fn(fd_beta, fd_ok, fsum, put(rj)))
                else:
                    for bi in range(n_bands):
                        dev = bi % len(grids)
                        if len(grids) > 1:
                            put = lambda x: jax.device_put(x, devices[dev])
                        else:
                            put = lambda x: x
                        futures.append(eye_fn(
                            put(jnp.uint32(i * self.width * self.height)),
                            put(jnp.float32(r)), grids[dev],
                            put(jnp.int32(bi * band_rows)),
                            consts_dev[dev], scene_dev[dev]))
                if self.phase_cb is not None:
                    self.phase_cb("bands_dispatched", futures)
                if dev_accum:
                    img_sum, img_comp = _accum_bands(img_sum, img_comp, *futures)
                else:
                    img = np.concatenate([np.asarray(b, np.float64)
                                          for b in futures])[:self.height]
                    img_sum += img[::-1]  # reference writes row (height-1-y)
                if self.phase_cb is not None:
                    self.phase_cb("stitch", None)
            if self.verbose:
                print(f"  iteration wall = "
                      f"{time.monotonic() - t_iter:.2f}s", flush=True)
            if output is not None:
                from .io.png import write_png
                avg = (img_sum / (i + 1)) ** (1.0 / 2.2)  # PPM gamma 1/2.2
                write_png(output, avg)
            if checkpoint_path is not None:
                tmp = checkpoint_path + ".tmp"
                np.savez(tmp if tmp.endswith(".npz") else tmp, img_sum=img_sum,
                         next_iteration=i + 1,
                         photon_count=self.photon_count, alpha=self.alpha)
                os.replace(tmp + (".npz" if not tmp.endswith(".npz") else ""),
                           checkpoint_path)
            self.iter_segments.append(
                (getattr(trace_photons, "last_segments", None),
                 self.width * self.height if eff_bounces == 1 else None))
            if checkpoint_cb is not None:
                checkpoint_cb(i, img_sum)
        if dev_accum:
            return np.asarray(img_sum, np.float64)
        return img_sum
