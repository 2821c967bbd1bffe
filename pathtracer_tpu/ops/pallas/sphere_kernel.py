"""Pallas-Triton kernel: brute-force nearest-hit ray/sphere-set intersection.

The GPU counterpart of the reference's native tier, the Rust AVX2
sphere-leaf intersector (`sphere-intersect-rs/src/lib.rs:102-178`). One
program owns RAY_BLOCK rays and walks the sphere table in SPH_CHUNK-wide
chunks: each step evaluates a (rays x spheres) tile of the quadratic in
registers, reduces it to the tile's nearest hit (minimum `a*t`, lowest
index on ties) and folds that into the running `(best a*t, index)`. One
pass over the table, no (N, S) intermediate in device memory, and a block
whose rays are all dead skips the loop.

Math and root choice are those of `ops/spheres.intersect_packed` (the
reference's stable quadratic, sphere.ml:35-54, including the
inside-with-b'<0 reject quirk), so the contract is the same: division-free
`a*t` keys plus the winner's index, with the stable `t` recomputed per ray
by the caller. The kernel divides nothing (`1/a` comes from XLA) and its
one `sqrt` lowers to libdevice's correctly rounded `__nv_sqrtf`; what can
differ from the XLA version is FMA contraction, which moves `a*t` by a few
ulps and can flip the winner of a near-tie.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import spheres

BIG = np.float32(3.0e38)
# block shape from an end-to-end sweep on the H100 (PERF.md): about 8 tile
# elements per thread; larger tiles spill registers and run 4-8x slower
RAY_BLOCK = 64  # rays per program
SPH_CHUNK = 16  # spheres per register tile
NUM_WARPS = 4
NUM_STAGES = 2


def pack_spheres(center, radius, valid):
    """(5, S_pad) float32 table [cx, cy, cz, A = r^2 - |c|^2, valid] with the
    sphere count padded to a multiple of SPH_CHUNK by invalid entries."""
    pad = (-center.shape[0]) % SPH_CHUNK
    cx, cy, cz, a_s, _ = spheres.pack_for_intersect(center, radius, valid)
    tbl = jnp.stack([cx, cy, cz, a_s, valid.astype(jnp.float32)])
    return jnp.pad(tbl.astype(jnp.float32), ((0, 0), (0, pad)))


def _kernel(cx_ref, cy_ref, cz_ref, as_ref, val_ref,
            o0_ref, o1_ref, o2_ref, d0_ref, d1_ref, d2_ref, a_ref, ia_ref,
            alive_ref, at_ref, idx_ref, *, n_chunks, t_min, t_max):
    alive = alive_ref[...] != 0
    at_ref[...] = jnp.full((RAY_BLOCK,), BIG, jnp.float32)
    idx_ref[...] = jnp.zeros((RAY_BLOCK,), jnp.int32)

    @pl.when(jnp.max(alive.astype(jnp.int32)) > 0)
    def _run():
        o0, o1, o2 = o0_ref[...], o1_ref[...], o2_ref[...]
        d0, d1, d2 = d0_ref[...], d1_ref[...], d2_ref[...]
        a, inv_a = a_ref[...], ia_ref[...]
        od = (o0 * d0 + o1 * d1 + o2 * d2)[:, None]
        oq = (o0 * o0 + o1 * o1 + o2 * o2)[:, None]
        lo = (np.float32(t_min) * a)[:, None]
        hi = (np.float32(t_max) * a)[:, None]
        o0, o1, o2 = o0[:, None], o1[:, None], o2[:, None]
        d0, d1, d2 = d0[:, None], d1[:, None], d2[:, None]
        a2, inv_a2 = a[:, None], inv_a[:, None]
        lane = lax.broadcasted_iota(jnp.int32, (RAY_BLOCK, SPH_CHUNK), 1)

        def body(c, carry):
            best_at, best_idx = carry
            sl = pl.ds(c * SPH_CHUNK, SPH_CHUNK)
            cx = cx_ref[sl][None, :]
            cy = cy_ref[sl][None, :]
            cz = cz_ref[sl][None, :]
            bp = cx * d0 + cy * d1 + cz * d2 - od
            g = as_ref[sl][None, :] + 2.0 * (cx * o0 + cy * o1 + cz * o2) - oq
            disc = g + bp * bp * inv_a2
            s = jnp.sqrt(a2 * disc)
            at = bp + jnp.where((g >= 0.0) & (bp >= 0.0), s, -s)
            ok = ((disc >= 0.0) & (at >= lo) & (at <= hi)
                  & (val_ref[sl][None, :] > 0.0))
            cand = jnp.where(ok, at, BIG)
            tmin = jnp.min(cand, axis=1)
            tidx = jnp.min(jnp.where(cand == tmin[:, None], lane,
                                     SPH_CHUNK), axis=1) + c * SPH_CHUNK
            # strict <: an equal key in a later chunk never steals the
            # win, so ties resolve to the lowest index as in XLA's version
            upd = tmin < best_at
            return (jnp.where(upd, tmin, best_at),
                    jnp.where(upd, tidx, best_idx))

        best_at, best_idx = lax.fori_loop(
            0, n_chunks, body,
            (jnp.full((RAY_BLOCK,), BIG, jnp.float32),
             jnp.zeros((RAY_BLOCK,), jnp.int32)))
        at_ref[...] = jnp.where(alive, best_at, BIG)
        idx_ref[...] = jnp.where(alive, best_idx, 0)


@functools.partial(jax.jit,
                   static_argnames=("t_min", "t_max", "interpret"))
def intersect_spheres(table, org, d, alive=None, t_min: float = 0.0,
                      t_max: float | None = None, interpret: bool = False):
    """Nearest hit of N rays against a `pack_spheres` table.

    org, d: (N, 3) float32, any N (padded here to the block); alive:
    optional (N,) bool, dead rays report a miss. Returns (at (N,) = a*t
    key, idx (N,) int32, hit (N,) bool, inv_a (N,)) like
    `spheres.intersect_packed`."""
    n = org.shape[0]
    n_pad = -(-n // RAY_BLOCK) * RAY_BLOCK
    s_pad = table.shape[1]
    assert s_pad % SPH_CHUNK == 0, s_pad
    a = jnp.sum(d * d, axis=1)
    inv_a = 1.0 / a
    if alive is None:
        alive = jnp.ones((n,), bool)

    def lanes(x):
        return jnp.pad(x, (0, n_pad - n))

    rays = [lanes(org[:, 0]), lanes(org[:, 1]), lanes(org[:, 2]),
            lanes(d[:, 0]), lanes(d[:, 1]), lanes(d[:, 2]),
            lanes(a), lanes(inv_a), lanes(alive.astype(jnp.int32))]
    t_hi = float(BIG) if t_max is None else min(float(t_max), float(BIG))
    tbl_spec = pl.BlockSpec((s_pad,), lambda i: (0,))
    ray_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    at, idx = pl.pallas_call(
        functools.partial(_kernel, n_chunks=s_pad // SPH_CHUNK,
                          t_min=float(t_min), t_max=t_hi),
        grid=(n_pad // RAY_BLOCK,),
        in_specs=[tbl_spec] * 5 + [ray_spec] * 9,
        out_specs=(ray_spec, ray_spec),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="sphere_nearest_hit",
    )(*table, *rays)
    at, idx = at[:n], idx[:n]
    return at, idx, at < BIG, inv_a
