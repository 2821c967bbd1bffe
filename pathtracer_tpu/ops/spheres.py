"""Vectorized ray-vs-sphere-set intersection.

Data-parallel counterpart of both the reference's scalar sphere test
(`sphere/src/sphere.ml:35-54`) and its 4-wide AVX2 Rust leaf kernel
(`sphere-intersect-rs/src/lib.rs:102-178`).

Design: for N rays x S spheres, the coupling terms are broadcast elementwise
chains that XLA fuses straight into the nearest-hit min-reduction — no (N,S)
intermediate ever reaches device memory (see intersect_packed for why not
matmuls):

    bp  = f.d           = c.d - o.d         (3 fma per pair)
    G   = r^2 - |f|^2   = (r^2-|c|^2) + 2 c.o - |o|^2

    discrim = G + bp^2/a                    (identity |f|^2 - bp^2/a = |perp|^2)
    a*t     = b' + sign'*sqrt(a*discrim)    (root choice below)

Root choice replicates the reference's stable quadratic exactly
(sphere.ml:44-53): q = fma(sign(b'), sqrt(a*discrim), b'); outside the sphere
(c = |f|^2-r^2 > 0) t = c/q, inside t = q/a. In `a*t` units that is
`b' - sqrt` outside and `b' + sign(b')*sqrt` inside — note when inside with
b' < 0 the reference selects the NEGATIVE root and therefore rejects the far
wall; this quirk affects internal dielectric rays and is preserved for
parity. Since a = |d|^2 > 0 is per-ray, `a*t` preserves nearest-hit ordering
across spheres, so the argmin runs division-free; the caller divides the
winning `a*t` by `a` (or recomputes the stable `c/q` from gathered sphere
params — see integrator.trace) once per ray.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import vec

BIG = np.float32(3.0e38)


def pack_for_intersect(center, radius, valid):
    """Precompute per-sphere broadcast vectors (host/once): the three center
    component rows and A = r^2 - |c|^2."""
    c2 = vec.quadrance(center)
    r2 = radius * radius
    return (center[:, 0], center[:, 1], center[:, 2], r2 - c2, r2)


def intersect_packed(cx, cy, cz, a_s, r2, valid, org, d, t_min=0.0, t_max=None,
                     precision=None):
    """Nearest-hit query given packed sphere vectors.

    Returns (at_best (N,) = a*t of the winning root, idx (N,) int32,
    hit (N,) bool, inv_a (N,)). t_hit = at_best*inv_a (see module docstring
    for a stable per-ray alternative).

    The (N,S) coupling terms are pure broadcast elementwise chains — NOT
    matmuls — so XLA fuses the entire quadratic + masking into the min
    reduction with no (N,S) array ever materialized in device memory. (A
    K=5 matmul formulation would force (N,S) intermediates of hundreds of
    MB at production ray counts.)
    """
    if t_max is None:
        t_max = BIG
    od = vec.dot(org, d)
    o2 = vec.quadrance(org)
    a = vec.quadrance(d)
    inv_a = 1.0 / a

    o0, o1, o2_ = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    d0, d1, d2 = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    # bp = f.d = c.d - o.d ; g = r^2 - |f|^2 = A + 2 c.o - |o|^2
    bp = cx[None, :] * d0 + cy[None, :] * d1 + cz[None, :] * d2 - od[:, None]
    g = (a_s[None, :] + 2.0 * (cx[None, :] * o0 + cy[None, :] * o1
                               + cz[None, :] * o2_) - o2[:, None])

    discrim = g + bp * bp * inv_a[:, None]
    s = jnp.sqrt(a[:, None] * discrim)  # NaN for misses; masked below
    at = bp + jnp.where((g >= 0.0) & (bp >= 0.0), s, -s)  # a * t_hit
    ok = (discrim >= 0.0) & (at >= t_min * a[:, None]) & \
         (at <= jnp.minimum(t_max, BIG) * a[:, None]) & valid[None, :]
    at_cand = jnp.where(ok, at, BIG)
    # one variadic (value, index) reduce: the first index of the minimum,
    # so ties go to the lowest sphere index
    idx = jnp.argmin(at_cand, axis=1).astype(jnp.int32)
    at_best = jnp.min(at_cand, axis=1)
    hit = at_best < BIG
    return at_best, idx, hit, inv_a


def stable_t(center_h, r2_h, org, d, a, inv_a):
    """Reference-stable t for the selected sphere from its gathered params
    (sphere.ml:35-54 evaluated per-ray on the winner only)."""
    f = center_h - org
    bp = vec.dot(f, d)
    quad_f = vec.quadrance(f)
    c = quad_f - r2_h
    discrim = r2_h - quad_f + bp * bp * inv_a
    sign_bp = jnp.where(bp >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))
    q = sign_bp * jnp.sqrt(jnp.maximum(a * discrim, 0.0)) + bp
    return jnp.where(c > 0.0, c / q, q * inv_a)


def intersect_brute(center, radius, valid, org, d, t_min=0.0, t_max=None,
                    precision=None):
    """Compatibility wrapper: returns (t_hit, idx, hit) with the stable t."""
    packed = pack_for_intersect(center, radius, valid)
    at, idx, hit, inv_a = intersect_packed(*packed, valid, org, d,
                                           t_min, t_max)
    a = vec.quadrance(d)
    t = stable_t(center[idx], (radius * radius)[idx], org, d, a, inv_a)
    return jnp.where(hit, t, BIG), idx, hit
