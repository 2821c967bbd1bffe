"""Film accumulation and reconstruction.

The reference splats each sample through a separable binomial filter stencil
into a per-tile float accumulator (`film_tile.ml:23-45`), stitches tiles
(including out-of-tile borders) into the image (`integrator.ml:114-128`), and
applies sqrt(x/spp) gamma (`integrator.ml:152-154`).

Key observation for the data-parallel design: `write_sample` truncates the
sample coordinates (`film_tile.ml:40-45`), and sample coords are pixel +
jitter with jitter in [0,1) — so every sample lands exactly on its own pixel
and the splat is a *fixed* 3x3 stencil centered there. Accumulating
per-pixel radiance sums and convolving once with the filter kernel is
bit-for-bit the same math, maps onto one fused XLA conv, and removes all
scatter traffic. Out-of-image stencil taps are dropped exactly like the
reference's stitch bounds check.

The binomial reconstruction kernel itself is built with exact rational
arithmetic (`fractions.Fraction`), mirroring the reference's use of the `Num`
bignum library (`filter_kernel/filter_kernel.ml:49-84`).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = ["binomial_kernel_1d", "binomial_kernel_2d", "apply_filter", "finalize"]


def _binomial_coeffs(order: int):
    """[C(order-1, k) for k in 0..order-1]."""
    c, out = 1, []
    n = order - 1
    for k in range(order):
        out.append(c)
        c = c * (n - k) // (k + 1)
    return out


def binomial_kernel_1d(order: int, pixel_radius: int) -> np.ndarray:
    """Resample binomial(order) coefficients to width 2r+1 with exact rational
    box-integration, then normalize (filter_kernel.ml:49-84)."""
    assert pixel_radius >= 0
    f_width = 1 + 2 * pixel_radius
    ratio = Fraction(order, f_width)
    coeffs = _binomial_coeffs(order)
    w = []
    for i in range(f_width):
        i_p = i * ratio
        j_p = i_p + ratio
        beg = i_p.numerator // i_p.denominator  # floor
        end = -((-j_p.numerator) // j_p.denominator)  # ceil
        length = end - beg
        total = Fraction(0)
        for k in range(length):
            if k == 0:
                weight = 1 - (i_p - beg)  # 1 - frac(i')
            elif k == length - 1:
                weight = 1 - (end - j_p)
            else:
                weight = Fraction(1)
            total += weight * coeffs[k + beg]
        w.append(total)
    s = sum(w)
    return np.array([float(x / s) for x in w], dtype=np.float64)


def binomial_kernel_2d(order: int, pixel_radius: int) -> np.ndarray:
    k = binomial_kernel_1d(order, pixel_radius)
    return np.outer(k, k)


def apply_filter(sums, kernel_2d, dtype=None):
    """Convolve per-pixel radiance sums (H, W, 3) with the reconstruction
    kernel (SAME zero padding == reference's drop-out-of-image semantics).

    Formulation note: a shifted-multiply-add graph (kh*kw padded slices)
    is the obvious alternative, but its mul+adds contract into FMAs
    differently depending on the surrounding graph, so the sharded and
    single-device stitches produced 1-ulp-different images from identical
    sums, breaking the placement-invariance bit-exactness tests (an
    optimization_barrier around the subgraph did not stop the contraction
    on CPU). The conv is a single opaque op and lowers identically
    everywhere."""
    dtype = dtype or sums.dtype
    k = jnp.asarray(kernel_2d, dtype)
    kh, kw = k.shape
    x = jnp.transpose(sums, (2, 0, 1))[None]  # (1, 3, H, W)
    kern = jnp.broadcast_to(k, (3, 1, kh, kw))  # depthwise: one filter per channel
    y = lax.conv_general_dilated(
        x.astype(dtype),
        kern,
        window_strides=(1, 1),
        padding="SAME",
        feature_group_count=3,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # HIGHEST: the GPU's default precision may run a float32 conv in
        # TF32 (about three decimal digits)
        precision=lax.Precision.HIGHEST,
    )
    return jnp.transpose(y[0], (1, 2, 0))  # (H, W, 3)


def finalize(filtered_sums, samples_per_pixel: int):
    """sqrt(x / spp) gamma map (integrator.ml:152-154)."""
    return jnp.sqrt(jnp.maximum(filtered_sums / samples_per_pixel, 0.0))
