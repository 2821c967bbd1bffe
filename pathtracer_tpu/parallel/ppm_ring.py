"""Ring-sharded PPM eye pass over a jax.sharding.Mesh.

Each device owns (a) one horizontal band of the image and (b) one photon
SUB-GRID built from its own photon trace chunks. One shard_map runs the
whole eye pass: the specular walk runs on the local band, the flux gather
visits every sub-grid by rotating the grids around the device ring with
`lax.ppermute` (n_dev-1 hops), accumulating partial flux locally. Photon
map memory per device stays 1/n_dev and the photon traffic rides the
device interconnect (NCCL over NVLink on GPUs), never the host — the
photon-map analog of ring attention, vs the reference's shared-host-memory
photon map (progressive_photon_map.ml:259-277) and the host-orchestrated
`shard_photon_map=True` mode in ppm.py, which dispatches each band and
partial gather as its own device call.

Determinism: the accumulation order per lane is fixed (own sub-grid, then
ring order), so images are reproducible; the association differs from the
replicated photon map by FP reordering only (~1e-6).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

__all__ = ["make_ppm_mesh", "pad_deposits", "stack_sharded_grids",
           "make_ring_eye_pass"]


def make_ppm_mesh(devices) -> Mesh:
    """1-D photon-parallel mesh: axis "pp" spans the given devices."""
    return Mesh(np.array(devices), ("pp",))


def pad_deposits(per_dev, n_dev, devices):
    """Equalize per-device deposit row counts (ring hops need uniform
    shapes): pad short deposit sets with ok=False rows, give devices that
    received no trace chunks an all-dead deposit set, and pin entry di to
    devices[di] (a single-chunk photon trace leaves its deposits on the
    DEFAULT device, which need not be devices[0] — stack_sharded_grids
    requires exact placement). Returns a list of exactly n_dev
    (pos, nrm, flux, ok) tuples and the uniform row count."""
    rows = max(o[0].shape[0] for o in per_dev)
    rows = max(rows, 1)
    out = []
    for di in range(n_dev):
        if di < len(per_dev):
            pos, nrm, flux, ok = per_dev[di]
            pad = rows - pos.shape[0]
            if pad:
                z3 = jnp.zeros((pad, 3), pos.dtype)
                pos = jnp.concatenate([pos, z3])
                nrm = jnp.concatenate([nrm, z3])
                flux = jnp.concatenate([flux, z3])
                ok = jnp.concatenate([ok, jnp.zeros((pad,), bool)])
            if next(iter(pos.devices())) != devices[di]:
                pos, nrm, flux, ok = (jax.device_put(x, devices[di])
                                      for x in (pos, nrm, flux, ok))
        else:  # no chunks landed here: all-dead deposits
            z3 = jax.device_put(jnp.zeros((rows, 3), jnp.float32),
                                devices[di])
            pos = nrm = flux = z3
            ok = jax.device_put(jnp.zeros((rows,), bool), devices[di])
        out.append((pos, nrm, flux, ok))
    return out, rows


def stack_sharded_grids(grids, jmesh: Mesh):
    """Assemble per-device grid pytrees (identical structure/shapes,
    grids[i] committed on jmesh.devices[i]) into ONE global pytree with a
    leading device axis sharded over "pp" — no host transfers
    (jax.make_array_from_single_device_arrays)."""
    n = len(grids)
    sharding = NamedSharding(jmesh, P("pp"))

    def one(*xs):
        arrs = [x[None] for x in xs]  # device-local leading axis
        shape = (n,) + tuple(xs[0].shape)
        return jax.make_array_from_single_device_arrays(shape, sharding,
                                                        arrs)

    return jax.tree.map(one, *grids)


def make_ring_photon_grid(trace_body, flatten, chunk: int, jmesh: Mesh,
                          grid_build):
    """ONE shard_map traces each device's photon chunk AND builds its
    sub-grid in-place: ring_trace(offset_base, radius, mesh_consts,
    scene) -> grid pytree with a leading device axis sharded over "pp" —
    exactly the stacked layout make_ring_eye_pass consumes. Requires one
    trace chunk per device (make_photon_pass sizes chunks that way up to
    131k lanes/device; past that the renderer falls back to the
    host-orchestrated trace + pad_deposits + stack_sharded_grids path).
    With make_ring_eye_pass this makes a full PPM iteration exactly two
    device programs with zero host photon traffic.

    trace_body/flatten/chunk: the un-jitted chunk tracer and deposit
    flattener exposed by ppm.make_photon_pass. grid_build(pos, nrm, flux,
    ok, radius) -> grid tuple (hash or morton/kernel tier)."""
    n_dev = jmesh.shape["pp"]

    @partial(shard_map, mesh=jmesh,
             in_specs=(P(), P("pp"), P(), P(), P()), out_specs=P("pp"),
             check_vma=False)
    def body(offset_base, lane_bases, radius, mesh_consts, scene):
        dep = trace_body(offset_base, lane_bases[0], mesh_consts or None,
                         scene)
        pos, nrm, flux, ok = flatten(dep)
        grid = grid_build(pos, nrm, flux, ok, radius)
        return jax.tree.map(lambda x: x[None], grid)  # (1,...) per shard

    @jax.jit
    def ring_trace(offset_base, radius, mesh_consts, scene):
        lane_bases = jnp.arange(n_dev, dtype=jnp.int32) * chunk
        return body(offset_base, lane_bases, radius, mesh_consts or {},
                    scene)

    return ring_trace


def make_ring_eye_pass(eye_raw, jmesh: Mesh, band_rows: int):
    """Build ring_pass(offset_base, radius, grid, mesh_consts, scene) ->
    (n_dev*band_rows, W, 3) image (the caller slices to the image height).

    eye_raw: the un-jitted product of ppm.make_eye_pass built with
    band_rows rows per device; its .walk/.finish/.make_gather stages are
    composed here inside one shard_map. The gather's dep_lanes is the
    UNIFORM per-device deposit row count (see pad_deposits)."""
    n_dev = jmesh.shape["pp"]
    ring = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def build(dep_rows_shard):
        gather = eye_raw.make_gather(dep_rows_shard)

        @partial(shard_map, mesh=jmesh,
                 in_specs=(P(), P(), P("pp"), P("pp"), P(), P()),
                 out_specs=P("pp"), check_vma=False)
        def ring_body(offset_base, radius, row0s, grid, mesh_consts, scene):
            g = jax.tree.map(lambda x: x[0], grid)  # drop the shard axis
            fd_pt, fd_nrm, fd_beta, fd_ok = eye_raw.walk(
                offset_base, row0s[0], mesh_consts or None, scene)
            flux = gather(fd_pt, fd_nrm, fd_ok, radius, g)
            for _ in range(n_dev - 1):
                g = jax.tree.map(lambda x: lax.ppermute(x, "pp", ring), g)
                flux = flux + gather(fd_pt, fd_nrm, fd_ok, radius, g)
            return eye_raw.finish(fd_beta, fd_ok, flux, radius)

        @jax.jit
        def ring_pass(offset_base, radius, grid, mesh_consts, scene):
            row0s = jnp.arange(n_dev, dtype=jnp.int32) * band_rows
            return ring_body(offset_base, radius, row0s, grid,
                             mesh_consts or {}, scene)

        return ring_pass

    return build
