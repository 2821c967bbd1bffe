"""Shading: tangent frames, scatter directions, masked material dispatch.

Vectorized equivalents of the reference's `Shader_space` / `Material` / `Pdf`
modules. The reference suspends a per-hit scatter closure inside `Hit.t`
(`hit.ml:3-7`, `material.ml:22-57`); here every branch of the material ADT is
computed for the whole wavefront and the result selected by material code —
the standard divergence-free dispatch for SIMD hardware.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import vec, quat

def shader_quat(normal):
    """Quaternion rotating world `normal` to local +Z (shader_space.ml:11-23).

    Branches (z near +1 -> identity; z near -1 -> 180deg about Y; else the
    half-angle construction normalize(1+z, (y, -x, 0))) become masked selects.

    The reference's epsilon is 1e-9 (shader_space.ml:8), which vanishes in
    float32 (1e-9 - 1.0 rounds to -1.0, so z == -1 would fall through to the
    generic branch and normalize a zero quaternion). We widen it to 1e-6 in
    float32 — the generic branch is numerically fine well inside that band,
    so only exactly-polar normals change branch.
    """
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    _EPS = 1e-9 if normal.dtype == jnp.float64 else 1e-6
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    # generic case; the normalize divides by sqrt((1+z)^2 + y^2 + x^2)
    qg = quat.normalize(quat.quat(1.0 + z, vec.v3(y, -x, zero)))
    q_id = quat.quat(one, vec.v3(zero, zero, zero))
    q_flip = quat.quat(zero, vec.v3(zero, one, zero))
    q = jnp.where((z > 1.0 - _EPS)[..., None], q_id, qg)
    q = jnp.where((z < _EPS - 1.0)[..., None], q_flip, q)
    return q


def world_ray(origin_pt, dir_world):
    """Offset the scattered ray origin by the shadow epsilon
    (shader_space.ml:51-54): origin + 1e-3 * dir."""
    return origin_pt + np.float32(1e-3) * dir_world


def reflect_local(w):
    """Mirror about local +Z: negate x, y (shader_space.ml:34-39)."""
    return w * jnp.asarray([-1.0, -1.0, 1.0], dtype=w.dtype)


def refract_local(wi, ratio):
    """Local-frame refraction (shader_space.ml:41-49)."""
    c = jnp.minimum(wi[..., 2], 1.0)
    zero = jnp.zeros_like(c)
    perp = (vec.v3(zero, zero, c) - wi) * ratio[..., None]
    para_z = -jnp.sqrt(jnp.abs(1.0 - vec.quadrance(perp)))
    return perp + vec.v3(zero, zero, para_z)


def cosine_hemisphere(u, v):
    """Cosine-weighted hemisphere map (shader_space.ml:56-64)."""
    r = jnp.sqrt(u)
    theta = v * np.float32(2.0 * np.pi)
    return vec.v3(r * jnp.cos(theta), r * jnp.sin(theta), jnp.sqrt(1.0 - u))


def schlick(cos_theta, index):
    """Schlick reflectance (material.ml:16-20)."""
    r0 = jnp.square((1.0 - index) / (1.0 + index))
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def scatter(mat_kind, albedo, ior, ior_inv, omega_i, hit_front, u, v):
    """Masked material dispatch (material.ml:22-57).

    All quantities are local-frame. Returns (wo_local (N,3),
    attn_mult (N,3), ok (N,) bool) where ok=False means the path terminates
    (Absorb, or diffuse pdf == 0).

    MIS note: the reference carries `diffuse_plus_light` scaffolding — the
    scatter ratio Pdf.eval(sample)/divisor at integrator.ml:50-58 — but its
    only Pdf constructor is Diffuse (pdf.ml:5-15) and every executable
    passes the diffuse pdf as both numerator and divisor
    (render_command.ml:81), so the ratio is identically 1. This port
    therefore folds the ratio away: the diffuse branch's attenuation is the
    albedo alone. If light-sampling MIS is ever added, reintroduce the
    explicit cos/pi eval here.
    """
    wi_z = omega_i[..., 2]
    white = jnp.ones_like(albedo)

    # Lambertian -> Diffuse: cosine-hemisphere sample; the only Pdf
    # constructor is Diffuse so pd/divisor == 1 exactly (pdf.ml:5-15,
    # render_command.ml:81); terminate if the sampled pd is 0.
    wo_lam = cosine_hemisphere(u, v)
    lam_ok = wo_lam[..., 2] > 0.0
    # Metal: mirror; absorb below horizon; Schlick-style tint
    # a + (1-a)*(1 - wi_z)^5 (material.ml:28-44).
    wo_met = reflect_local(omega_i)
    met_ok = wo_met[..., 2] > 0.0
    s5 = (1.0 - wi_z) ** 5
    attn_met = albedo + (white - albedo) * s5[..., None]
    # Dielectric: reflect on TIR or Schlick > u, else refract; white
    # attenuation (material.ml:45-56).
    ci = jnp.clip(wi_z, 0.0, 1.0)
    si = jnp.sqrt(1.0 - jnp.square(ci))
    ratio = jnp.where(hit_front, ior_inv, ior)
    do_reflect = (ratio * si > 1.0) | (schlick(ci, ratio) > u)
    wo_die = vec.where3(do_reflect, reflect_local(omega_i), refract_local(omega_i, ratio))

    is_met = mat_kind == 1
    is_die = mat_kind == 2
    wo = vec.where3(is_die, wo_die, vec.where3(is_met, wo_met, wo_lam))
    attn = vec.where3(is_die, white, vec.where3(is_met, attn_met, albedo))
    ok = jnp.where(is_die, True, jnp.where(is_met, met_ok, lam_ok))
    return wo, attn, ok
