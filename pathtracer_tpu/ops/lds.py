"""Roberts R_d low-discrepancy sequence, evaluated on the device.

Behavioral parity with the reference sampler
(`low_discrepancy_sequence/src/low_discrepancy_sequence.ml:8-37`):

    phi_D  = unique real root of x^(D+1) = x + 1   (fixed-point iteration)
    alpha_d = phi_D^-(d+1)                          for d in [0, D)
    sample(offset, d) = frac(0.5 + alpha_d * (offset + 1))

The reference evaluates this in float64. The device path runs with x64 off
(and GPUs run fp64 far slower than fp32), so the hot
path here uses **64-bit fixed-point arithmetic built from uint32 limbs**:
alpha_d is pre-scaled to a 64-bit integer fraction alpha*2^64 on the host, and
the device computes (2^63 + alpha_fix * (offset+1)) mod 2^64 with 16-bit limb
products (uint32 multiplies wrap mod 2^32 natively). The
top 32 bits of the result give the sample. Max deviation from the exact real
value is ~(offset+1)*2^-64, i.e. < 1e-12 for any realistic offset — far below
float32 resolution, and below the reference's own float64 rounding error at
large offsets.

A float64 host (numpy) implementation is provided as the test oracle.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "phi",
    "alphas_f64",
    "sample_f64",
    "alphas_fixed64",
    "sample_fixed",
    "Sampler",
]


def phi(dimension: int) -> float:
    """Unique positive root of x^(d+1) = x + 1, by the reference's fixed-point
    iteration x <- (1+x)^(1/(d+1)) from x0=2.0, iterated to float64 fixpoint."""
    assert dimension >= 1
    dinv = 1.0 / (float(dimension) + 1.0)
    x = 2.0
    while True:
        x2 = (1.0 + x) ** dinv
        if x2 == x:
            return x
        x = x2


def alphas_f64(dimension: int) -> np.ndarray:
    """alpha_d = phi_D^-(d+1) for d in [0, D), float64 (host)."""
    p = phi(dimension)
    return np.array([1.0 / (p ** float(i + 1)) for i in range(dimension)], dtype=np.float64)


def sample_f64(alphas: np.ndarray, offset, dimension) -> np.ndarray:
    """Float64 oracle: frac(0.5 + alpha_d*(offset+1)); numpy, vectorized."""
    offset = np.asarray(offset, dtype=np.float64)
    x = 0.5 + alphas[dimension] * (offset + 1.0)
    return x - np.trunc(x)


def alphas_fixed64(dimension: int) -> np.ndarray:
    """alpha_d scaled to 64-bit fixed point, returned as uint32 (D, 2) [hi, lo]."""
    a = alphas_f64(dimension)
    out = np.empty((dimension, 2), dtype=np.uint32)
    for i, x in enumerate(a):
        # alpha in (0,1); round(alpha * 2^64) as an exact python int
        v = int(round(x * (1 << 64))) & ((1 << 64) - 1)
        out[i, 0] = (v >> 32) & 0xFFFFFFFF
        out[i, 1] = v & 0xFFFFFFFF
    return out


_MASK16 = np.uint32(0xFFFF)
_HALF = np.uint32(0x80000000)
# Largest float32 strictly below 1.0, used to keep samples in [0,1).
_ONE_MINUS_EPS = np.float32(1.0 - 2.0 ** -24)


def sample_fixed(alpha_hi, alpha_lo, offset):
    """Fixed-point LDS evaluation on device.

    alpha_hi, alpha_lo: uint32 arrays (broadcastable against offset) — the two
    32-bit limbs of alpha*2^64. offset: uint32 array of sample offsets.
    Returns float32 samples in [0, 1).
    """
    m = (offset + np.uint32(1)).astype(jnp.uint32)
    alpha_hi = jnp.asarray(alpha_hi, jnp.uint32)
    alpha_lo = jnp.asarray(alpha_lo, jnp.uint32)
    # 64-bit product (alpha_lo * m) via 16-bit limbs; uint32 ops wrap mod 2^32.
    p0 = alpha_lo & _MASK16
    p1 = alpha_lo >> 16
    q0 = m & _MASK16
    q1 = m >> 16
    pp0 = p0 * q0
    pp1a = p0 * q1
    pp1b = p1 * q0
    t1 = pp0 + (pp1a << 16)
    c1 = (t1 < pp0).astype(jnp.uint32)
    t2 = t1 + (pp1b << 16)
    c2 = (t2 < t1).astype(jnp.uint32)
    hi = alpha_hi * m + p1 * q1 + (pp1a >> 16) + (pp1b >> 16) + c1 + c2
    v = hi + _HALF  # +0.5 in fixed point affects only the hi word
    s = v.astype(jnp.float32) * np.float32(2.0 ** -32)
    return jnp.minimum(s, _ONE_MINUS_EPS)


class Sampler:
    """Precomputed fixed-point sampler for a given total dimension count.

    Mirrors `L.create ~dimension` — note phi depends on the TOTAL dimension
    count D (the reference uses D = 2 + 2*max_bounces for the path tracer,
    `integrator.ml:89`), so the sampler must be created per-render-config.
    """

    def __init__(self, dimension: int):
        self.dimension = dimension
        self.alphas = alphas_f64(dimension)
        fixed = alphas_fixed64(dimension)
        # HOST numpy limb tables, indexed by dimension. These deliberately
        # stay numpy: an eagerly-created jax device array closed over by a
        # jit becomes an MLIR constant at lowering, which copies it back
        # device->host; numpy constants lower via the host path directly.
        self.hi = np.ascontiguousarray(fixed[:, 0])
        self.lo = np.ascontiguousarray(fixed[:, 1])

    def get(self, offset, dimension: int):
        """Device evaluation; `dimension` is a static python int."""
        return sample_fixed(self.hi[dimension], self.lo[dimension], offset)

    def get_dyn(self, offset, dimension):
        """Device evaluation with a traced dimension index."""
        hi = jnp.asarray(self.hi)[dimension]
        lo = jnp.asarray(self.lo)[dimension]
        return sample_fixed(hi, lo, offset)

    def get_f64(self, offset, dimension):
        """Host float64 oracle evaluation."""
        return sample_f64(self.alphas, offset, dimension)
