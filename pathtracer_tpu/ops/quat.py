"""Batched unit-quaternion rotations, stored as (..., 4) arrays [w, x, y, z].

Vectorized equivalent of the reference's `Quaternion` module
(`path_tracer/src/quaternion.ml:1-43`); `rotate` uses the standard
2-cross-product expansion of q·(0,v)·q* which costs fewer multiplies than
two quaternion products.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import vec

__all__ = ["quat", "identity", "normalize", "mul", "conj", "rotate", "rotate_inv", "from_axis_angle"]


def quat(w, v):
    """Build a quaternion from scalar part (...,) and vector part (..., 3)."""
    return jnp.concatenate([jnp.asarray(w)[..., None], v], axis=-1)


def identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def normalize(q):
    return q * vec.jax_rsqrt(jnp.sum(q * q, axis=-1))[..., None]


def mul(a, b):
    """Hamilton product (quaternion.ml:25-32)."""
    aw, av = a[..., 0], a[..., 1:]
    bw, bv = b[..., 0], b[..., 1:]
    w = aw * bw - vec.dot(av, bv)
    v = vec.cross(av, bv) + av * bw[..., None] + bv * aw[..., None]
    return quat(w, v)


def conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def rotate(q, v):
    """Rotate v by q: equivalent to q·(0,v)·q* (quaternion.ml:39-42)."""
    w, qv = q[..., 0], q[..., 1:]
    t = 2.0 * vec.cross(qv, v)
    return v + t * w[..., None] + vec.cross(qv, t)


def rotate_inv(q, v):
    """Rotate v by q* (the inverse rotation for unit q)."""
    return rotate(conj(q), v)


def from_axis_angle(axis, angle):
    """Unit quaternion rotating by `angle` about `axis` (quaternion.ml:17-23)."""
    axis = vec.normalize(axis)
    half = jnp.asarray(angle) * 0.5
    return normalize(quat(jnp.cos(half), axis * jnp.sin(half)[..., None]))
