"""Pallas-Triton kernel: PPM cone-filter photon gather over chunk lists.

The XLA gather (`ppm.hash_gather`) walks 27 hash-grid cells with a
per-lane cursor in a `while_loop` that runs as long as the worst lane of
its chunk has photons; every step is a few small kernels and a loop test.
Here one program owns HIT_BLOCK Morton-sorted eye hits and loops, on the
SM, over its own candidate list of CHUNK-photon chunks
(`ops/photon_chunks.block_chunk_lists`). Each step loads one chunk's
planes and evaluates a (hits x photons) tile of the distance, normal and
cone-weight tests, reduced over photons into three per-hit sums.

The cone weight `1 - sqrt(d^2) / r` takes `1/r` from the caller, so the
kernel divides nothing, and its `sqrt` lowers to libdevice's correctly
rounded `__nv_sqrtf`. Photons are summed in another order than in the
hash gather, so the two agree to float32 reassociation, not bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..photon_chunks import CHUNK, HIT_BLOCK, block_chunk_lists

NUM_WARPS = 4
NUM_STAGES = 2


def _kernel(cnt_ref, list_ref, ph_ref, hit_ref, r_ref, out_ref):
    cnt = cnt_ref[0]
    x, y, z = hit_ref[0, :], hit_ref[1, :], hit_ref[2, :]
    nx, ny, nz = hit_ref[3, :], hit_ref[4, :], hit_ref[5, :]
    active = hit_ref[6, :] > 0.0
    r2, inv_r = r_ref[0], r_ref[1]
    x, y, z = x[:, None], y[:, None], z[:, None]
    nx, ny, nz = nx[:, None], ny[:, None], nz[:, None]

    def body(k, acc):
        sl = pl.ds(list_ref[k] * CHUNK, CHUNK)
        dx = ph_ref[0, sl][None, :] - x
        dy = ph_ref[1, sl][None, :] - y
        dz = ph_ref[2, sl][None, :] - z
        d2 = dx * dx + dy * dy + dz * dz
        ndot = (ph_ref[3, sl][None, :] * nx + ph_ref[4, sl][None, :] * ny
                + ph_ref[5, sl][None, :] * nz)
        ok = (d2 < r2) & (ndot > np.float32(1e-3))
        w = jnp.where(ok, 1.0 - jnp.sqrt(d2) * inv_r, 0.0)  # cone, k=1
        return (acc[0] + jnp.sum(w * ph_ref[6, sl][None, :], axis=1),
                acc[1] + jnp.sum(w * ph_ref[7, sl][None, :], axis=1),
                acc[2] + jnp.sum(w * ph_ref[8, sl][None, :], axis=1))

    zero = jnp.zeros((HIT_BLOCK,), jnp.float32)
    acc = lax.fori_loop(0, cnt, body, (zero, zero, zero))
    for c in range(3):
        out_ref[c, :] = jnp.where(active, acc[c], 0.0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def gather_flux(point, normal, active, cbox, photons_t, radius,
                interpret: bool = False):
    """Cone-filter flux sums of n eye hits against a chunked photon map.

    point/normal: (n, 3), ideally Morton-sorted so blocks are compact;
    active: (n,) bool; cbox/photons_t from `build_photon_chunks`; radius:
    scalar. Returns flux (n, 3); inactive hits get zero."""
    n = point.shape[0]
    n_pad = -(-n // HIT_BLOCK) * HIT_BLOCK
    pad = n_pad - n
    point = jnp.pad(point, ((0, pad), (0, 0)))
    normal = jnp.pad(normal, ((0, pad), (0, 0)))
    active = jnp.pad(active, (0, pad))
    lists, counts = block_chunk_lists(point, active, cbox, radius)
    nblk, n_chunks = lists.shape
    hits = jnp.concatenate([point.T, normal.T,
                            active[None].astype(jnp.float32)])
    radius = jnp.asarray(radius, jnp.float32)
    r_in = jnp.stack([radius * radius, 1.0 / radius])
    out = pl.pallas_call(
        _kernel,
        grid=(nblk,),
        in_specs=[pl.BlockSpec((1,), lambda i: (i,)),
                  pl.BlockSpec((None, n_chunks), lambda i: (i, 0)),
                  pl.BlockSpec(photons_t.shape, lambda i: (0, 0)),
                  pl.BlockSpec((7, HIT_BLOCK), lambda i: (0, i)),
                  pl.BlockSpec((2,), lambda i: (0,))],
        out_specs=pl.BlockSpec((3, HIT_BLOCK), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((3, n_pad), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="photon_gather",
    )(counts, lists, photons_t, hits, r_in)
    return out[:, :n].T
