"""Photon map as Morton-sorted chunks with exact bounding boxes.

The reference gathers per eye hit with a BVH point query
(`progressive_photon_map.ml:319-371` via `shape_tree.ml:222-231`). The
chunk layout is its flat, density-adaptive analog: valid deposits are
sorted by a 30-bit Morton code over their own bounding box and cut into
CHUNK-photon chunks, each with the exact f32 box of its members. A block
of Morton-sorted eye hits then needs only the chunks whose box comes
within the gather radius of the block's box (`block_chunk_lists`), and the
gather kernel (`ops/pallas/gather_kernel.py`) walks that list. The box
test is only a candidate filter: the kernel's per-photon `d^2 < r^2` test
is the exact membership test, so any superset is correct and a skipped
chunk contributes exactly +0.0.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

CHUNK = 32  # photons per chunk (one bounding box each)
HIT_BLOCK = 128  # eye hits per gather program (one candidate list each)
_BIG = np.float32(3.0e38)


def morton3(cx, cy, cz):
    """Interleave three ints of up to 10 bits (x lowest) into one key."""
    def expand(v):
        v = v.astype(jnp.uint32)
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v
    return (expand(cx) | (expand(cy) << 1) | (expand(cz) << 2)).astype(
        jnp.int32)


def morton_keys(pos, valid):
    """30-bit Morton key over the valid points' own bbox; invalid last.
    Sorts photons into chunks and eye hits into compact kernel blocks."""
    lo = jnp.min(jnp.where(valid[:, None], pos, _BIG), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], pos, -_BIG), axis=0)
    ext = jnp.maximum(hi - lo, np.float32(1e-9))
    c = jnp.clip(((pos - lo[None, :]) / ext[None, :]
                  * np.float32(1024.0)).astype(jnp.int32), 0, 1023)
    key = morton3(c[:, 0], c[:, 1], c[:, 2])
    return jnp.where(valid, key, jnp.int32(1 << 30))


@jax.jit
def build_photon_chunks(pos, nrm, flux, valid):
    """Sort valid deposits by Morton code and box every CHUNK of them.

    Radius-independent (r enters only at query time). Returns
      photons_t: (9, Np_pad) f32 [pos3, nrm3, flux3]; invalid deposits and
                 padding carry +BIG positions, which fail any radius test;
      cbox: (6, n_chunks) f32 [lo3, hi3] per chunk over its valid members;
            a chunk with none is inverted (lo=+BIG > hi=-BIG) and
            overlaps nothing."""
    npho = pos.shape[0]
    _, order = jax.lax.sort_key_val(morton_keys(pos, valid),
                                    jnp.arange(npho, dtype=jnp.int32))
    posm = jnp.where(valid[:, None], pos, _BIG)
    planes = jnp.concatenate([posm.T, nrm.T, flux.T])[:, order]
    vs = valid[order]
    np_pad = -(-npho // CHUNK) * CHUNK
    photons_t = jnp.pad(planes, ((0, 0), (0, np_pad - npho)),
                        constant_values=_BIG)
    lo = photons_t[0:3]
    hi = jnp.pad(jnp.where(vs[None, :], planes[0:3], -_BIG),
                 ((0, 0), (0, np_pad - npho)), constant_values=-_BIG)
    n_chunks = np_pad // CHUNK
    c_lo = jnp.min(lo.reshape(3, n_chunks, CHUNK), axis=2)
    c_hi = jnp.max(hi.reshape(3, n_chunks, CHUNK), axis=2)
    return photons_t, jnp.concatenate([c_lo, c_hi])


def block_chunk_lists(point, active, cbox, radius):
    """Candidate chunks of each HIT_BLOCK-hit block, in ascending order.

    point (n, 3) should be Morton-sorted so blocks are compact; n must be a
    multiple of HIT_BLOCK. Returns (lists (nblk, n_chunks) i32, counts
    (nblk,) i32): row b's first counts[b] entries are the chunks whose box
    comes within the radius of block b's active hits."""
    n = point.shape[0]
    nblk = n // HIT_BLOCK
    n_chunks = cbox.shape[1]
    pr = point.reshape(nblk, HIT_BLOCK, 3)
    am = active.reshape(nblk, HIT_BLOCK, 1)
    # the radius is padded a hair so f32 rounding of (min - r) can never
    # drop a photon just inside r; a superset is always exact
    r_pad = radius * np.float32(1.000002) + np.float32(1e-30)
    blo = jnp.min(jnp.where(am, pr, _BIG), axis=1) - r_pad  # (nblk, 3)
    bhi = jnp.max(jnp.where(am, pr, -_BIG), axis=1) + r_pad
    ov = am[:, :, 0].any(axis=1)[:, None]
    for ax in range(3):
        ov = ov & (cbox[3 + ax][None, :] >= blo[:, ax:ax + 1]) \
            & (cbox[ax][None, :] <= bhi[:, ax:ax + 1])
    slot = jnp.cumsum(ov, axis=1, dtype=jnp.int32) - 1
    rows = jnp.arange(nblk, dtype=jnp.int32)[:, None]
    ci = jnp.broadcast_to(jnp.arange(n_chunks, dtype=jnp.int32),
                          (nblk, n_chunks))
    lists = jnp.zeros((nblk, n_chunks), jnp.int32).at[
        rows, jnp.where(ov, slot, n_chunks)].set(ci, mode="drop")
    return lists, slot[:, -1] + 1
