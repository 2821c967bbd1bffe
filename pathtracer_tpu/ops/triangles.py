"""Vectorized ray-vs-triangle-set intersection (Möller–Trumbore).

Vectorized counterpart of the reference's `Triangle.Make(Face).intersect`
(`triangle/triangle.ml:74-98`): for N rays x T triangles all terms are
broadcast elementwise chains fused into the nearest-hit reduction, exactly
like ops/spheres. Epsilon and acceptance conditions replicate the reference:
|det| < 1e-6 -> miss; 0 <= u <= 1, 0 <= v, u+v <= 1; t in [t_min, t_max].

Triangles are stored as (a, e1, e2) with e1 = b-a, e2 = c-a precomputed.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

BIG = np.float32(3.0e38)
_EPS = np.float32(1e-6)


def pack_for_intersect(a, e1, e2, valid):
    """Per-triangle component vectors for broadcasting (host/once)."""
    comps = {}
    for name, arr in (("a", a), ("e1", e1), ("e2", e2)):
        for k, ax in enumerate("xyz"):
            comps[f"{name}{ax}"] = arr[:, k]
    comps["valid"] = valid
    return comps


def intersect_tris(tc, org, d, t_min=0.0, t_max=None):
    """Nearest-hit of N rays against T triangles.

    tc: packed components from pack_for_intersect. org, d: (N, 3).
    Returns (t (N,), u (N,), v (N,), idx (N,) int32, hit (N,) bool).
    """
    if t_max is None:
        t_max = BIG
    d0, d1, d2 = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    o0, o1, o2 = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    e1x, e1y, e1z = tc["e1x"][None], tc["e1y"][None], tc["e1z"][None]
    e2x, e2y, e2z = tc["e2x"][None], tc["e2y"][None], tc["e2z"][None]
    ax, ay, az = tc["ax"][None], tc["ay"][None], tc["az"][None]

    # pvec = d x e2  (N,T per component)
    pvx = d1 * e2z - d2 * e2y
    pvy = d2 * e2x - d0 * e2z
    pvz = d0 * e2y - d1 * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = jnp.abs(det) >= _EPS
    det_inv = 1.0 / det
    # tvec = o - a
    tvx, tvy, tvz = o0 - ax, o1 - ay, o2 - az
    u = det_inv * (tvx * pvx + tvy * pvy + tvz * pvz)
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = det_inv * (d0 * qvx + d1 * qvy + d2 * qvz)
    t = det_inv * (e2x * qvx + e2y * qvy + e2z * qvz)
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_max) & tc["valid"][None, :])
    t_cand = jnp.where(ok, t, BIG)
    t_best = jnp.min(t_cand, axis=1)
    n_t = t_cand.shape[1]
    iota = jnp.arange(n_t, dtype=jnp.int32)
    idx = jnp.min(jnp.where(t_cand == t_best[:, None], iota[None, :], n_t),
                  axis=1).astype(jnp.int32)
    idx = jnp.minimum(idx, n_t - 1)
    hit = t_best < BIG
    return t_best, idx, hit


def mt_single(a, e1, e2, org, d):
    """Per-ray Möller–Trumbore against each ray's own (gathered) triangle.

    a, e1, e2: (N, 3) winner-triangle data; org, d: (N, 3).
    Returns (t, u, v) — used to recompute barycentrics for shading instead of
    gathering them out of the (N, T) sweep (gathers from (N, T) rows are
    strided reads).
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_inv = 1.0 / det
    tvec = org - a
    u = det_inv * jnp.sum(tvec * pvec, axis=-1)
    qvec = jnp.cross(tvec, e1)
    v = det_inv * jnp.sum(d * qvec, axis=-1)
    t = det_inv * jnp.sum(e2 * qvec, axis=-1)
    return t, u, v
