"""Multi-chip data parallelism over a jax.sharding.Mesh.

Device-parallel equivalent of the reference's domainslib tile fork-join
(`integrator.ml:130-156`): the sample grid is sharded over a 2-D device mesh —
axis "dp" shards spp passes, axis "sp" shards image rows (the tile analog) —
with `shard_map`. The per-device partial films are reduced with `psum` over
"dp" (the Chan+stitch equivalent) and remain row-sharded over "sp" until the
reconstruction conv. Determinism is free: the LDS sampler is positional, so
the result is independent of how work is laid out across chips
(low_discrepancy_sequence.ml:33-36 — same property the reference relies on
for tile-order independence).

Scene/BVH arrays are replicated (the reference shares the immutable BVH
across domains by shared memory; we broadcast via `jax.device_put`).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import film
from ..integrator import TILE, make_pass_fn, resolve_backend

__all__ = ["make_mesh", "make_sharded_render_fn"]


def make_mesh(dp: int, sp: int, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= dp * sp, (len(devices), dp, sp)
    dev = np.array(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(dev, ("dp", "sp"))


def make_sharded_render_fn(camera, background, width, height, spp, max_bounces,
                           mesh: Mesh, dtype=jnp.float32, intersect_fn=None,
                           filter_order=5, filter_radius=1,
                           backend: str | None = None,
                           tiled: bool | None = None, scene_mesh=None,
                           interpret: bool = False):
    """Build a jitted render(scene) -> (image (H,W,3), segments) running
    across `mesh` with passes sharded over "dp" and rows over "sp".

    tiled (default: on with the kernel tier, as on one device): shard BANDS
    OF 32-ROW TILE-ROWS over "sp" so several devices run the same
    tile-major layout and kernels as one. backend and interpret follow
    make_pass_fn."""
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    # Pad non-divisible work instead of refusing it (the reference's tile
    # split handles ragged edges the same way, tile.ml:28-39): passes are
    # padded with masked-out ids, rows/tile-rows with dead or clamped
    # duplicates sliced off after the stitch.
    spp_pad = -(-spp // dp) * dp
    backend = resolve_backend(backend)
    if tiled is None:
        tiled = backend == "triton"
    kern2d = film.binomial_kernel_2d(filter_order, filter_radius)
    # mesh device arrays ride through shard_map as REPLICATED ARGUMENTS —
    # same rule as make_render_fn: closed-over device arrays become HLO
    # constants (compile-time explosion), and the numpy fallbacks inside
    # make_intersector cannot be indexed by traced ids (see
    # MeshBVH.device_consts)
    mesh_consts = scene_mesh.device_consts() if scene_mesh is not None else {}

    if tiled:
        tyn = -(-height // TILE)
        band = -(-tyn // sp)  # tile-rows per shard
        pass_fn = make_pass_fn(camera, background, width, height, spp,
                               max_bounces, dtype, intersect_fn,
                               tiled=True, band_tile_rows=band,
                               backend=backend, mesh=scene_mesh,
                               interpret=interpret)

        # check_vma=False: pallas_call's out_shapes carry no vma
        # annotations, so the varying-across-mesh checker rejects any
        # kernel launch inside shard_map; the untiled path keeps the check
        @partial(shard_map, mesh=mesh, in_specs=(P(), P(), P("dp"), P("sp")),
                 out_specs=(P("sp"), P()), check_vma=False)
        def partial_sums(scene, mc, passes, tile_row0):
            def body(acc, p):
                live = (p < spp).astype(dtype)
                s, segs = pass_fn(scene, jnp.minimum(p, spp - 1),
                                  tile_row0[0], mesh_consts=mc or None)
                return acc + s * live, segs * (p < spp)

            init = jnp.zeros((band * TILE, width, 3), dtype)
            init = lax.pcast(init, ("dp", "sp"), to="varying")
            sums, segs = lax.scan(body, init, passes)
            sums = lax.psum(sums, "dp")
            total = lax.psum(jnp.sum(segs), ("dp", "sp"))
            return sums, total

        @jax.jit
        def render_impl(scene, mc):
            passes = jnp.arange(spp_pad, dtype=jnp.int32)
            row0s = jnp.arange(sp, dtype=jnp.int32) * band
            sums, segs = partial_sums(scene, mc, passes, row0s)
            sums = sums[:height]
            img = film.finalize(film.apply_filter(sums, kern2d, dtype), spp)
            return img, segs

        return lambda scene: render_impl(scene, mesh_consts)

    h_pad = -(-height // sp) * sp
    pass_fn = make_pass_fn(camera, background, width, height, spp, max_bounces,
                           dtype, intersect_fn, dynamic_rows=True,
                           backend=backend, mesh=scene_mesh,
                           interpret=interpret)

    # check_vma off when a mesh walk or a kernel runs inside: the walk's
    # while_loop carry mixes replicated (table-derived) and varying
    # (ray-derived) components, which the varying-across-mesh checker
    # rejects even though the computation is per-lane pure
    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P("dp"), P("sp")),
             out_specs=(P("sp"), P()),
             check_vma=scene_mesh is None and backend == "xla")
    def partial_sums(scene, mc, passes, row_ids):
        def body(acc, p):
            live = (p < spp).astype(dtype)
            s, segs = pass_fn(scene, jnp.minimum(p, spp - 1), row_ids,
                              mesh_consts=mc or None)
            return acc + s * live, segs * (p < spp)

        rows = row_ids.shape[0]
        init = jnp.zeros((rows, width, 3), dtype)
        # mark the carry as varying over the mesh axes (shard_map vma rules)
        init = lax.pcast(init, ("dp", "sp"), to="varying")
        sums, segs = lax.scan(body, init, passes)
        sums = lax.psum(sums, "dp")
        total = lax.psum(jnp.sum(segs), ("dp", "sp"))
        return sums, total

    @jax.jit
    def render(scene):
        passes = jnp.arange(spp_pad, dtype=jnp.int32)
        row_ids = jnp.minimum(jnp.arange(h_pad, dtype=jnp.int32), height - 1)
        sums, segs = partial_sums(scene, mesh_consts, passes, row_ids)
        sums = sums[:height]
        img = film.finalize(film.apply_filter(sums, kern2d, dtype), spp)
        return img, segs

    return render
