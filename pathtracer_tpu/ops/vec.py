"""3-vector algebra over arrays with trailing dim 3.

Vectorized replacement for the reference's record-of-floats V3/P3 modules
(`path_tracer/src/affine.ml:13-93`): every operation is batched/elementwise
over leading dims, so a "vector" here is an array of shape (..., 3) and all
ops vectorize over the wavefront for free.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "v3", "dot", "quadrance", "norm", "normalize", "cross", "scale",
    "lerp", "where3", "unit_x", "unit_y", "unit_z",
]


def v3(x, y, z):
    """Stack scalars/arrays into a trailing-dim-3 vector array."""
    return jnp.stack(jnp.broadcast_arrays(x, y, z), axis=-1)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def quadrance(a):
    return dot(a, a)


def norm(a):
    return jnp.sqrt(quadrance(a))


def normalize(a):
    return a * jax_rsqrt(quadrance(a))[..., None]


def jax_rsqrt(x):
    import jax
    return jax.lax.rsqrt(x)


def cross(a, b):
    # (path_tracer/src/affine.ml:83-86)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return v3(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def scale(a, s):
    return a * jnp.asarray(s)[..., None]


def lerp(t, a, b):
    """(1-t)*a + t*b with scalar-or-batched t (affine.ml:66)."""
    t = jnp.asarray(t)[..., None]
    return a * (1.0 - t) + b * t


def where3(mask, a, b):
    """Select whole vectors by a (...,)-shaped boolean mask."""
    return jnp.where(mask[..., None], a, b)


def unit_x(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0], dtype=dtype)


def unit_y(dtype=jnp.float32):
    return jnp.array([0.0, 1.0, 0.0], dtype=dtype)


def unit_z(dtype=jnp.float32):
    return jnp.array([0.0, 0.0, 1.0], dtype=dtype)
