#!/usr/bin/env python
"""Microbenchmark suite — the reference's core_bench harness analog
(bench/intersect_bench.ml:33-58, bench/quaternion_bench.ml:23-67):
bbox hit/miss slab tests, sphere intersection hit/miss, quaternion
mul/conj/rotate, shader-space frame construction, plus the device
kernels (sphere intersect in XLA and as the Pallas-Triton kernel on a GPU,
LDS sampler, film reconstruction).

All timings run the op inside a lax.scan with data dependencies between
iterations (a single small call measures mostly dispatch overhead) and end
in block_until_ready.

Usage: python bench_micro.py [--cpu]
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-n", type=int, default=1 << 20, help="batch size")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        raise SystemExit(f"bench_micro.py needs a GPU (or --cpu); JAX found "
                         f"{dev.platform}")
    where = f"{dev.platform}:{dev.device_kind}x{len(jax.devices())}"
    import jax.numpy as jnp
    from jax import lax

    from pathtracer_tpu.ops import quat, shading, spheres, vec
    from pathtracer_tpu.ops.lds import Sampler

    n = args.n
    rs = np.random.RandomState(0)
    R = 16

    def bench(name, make_step, init, units_per_iter):
        @jax.jit
        def run(x):
            def body(c, _):
                return make_step(c), None
            c, _ = lax.scan(body, x, None, length=R)
            return jnp.sum(jax.tree.leaves(c)[0])

        jax.block_until_ready(run(init))
        best = 1e9
        for _i in range(4):
            t0 = time.perf_counter()
            jax.block_until_ready(run(init))
            best = min(best, time.perf_counter() - t0)
        per = best / R / units_per_iter
        print(f"{name:34s} {per * 1e9:10.3f} ns/op   "
              f"({units_per_iter / (best / R) / 1e6:9.1f} Mop/s)  [{where}]")

    v = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    w = jnp.asarray(rs.randn(n, 3).astype(np.float32))
    q0 = quat.from_axis_angle(v, jnp.asarray(rs.rand(n).astype(np.float32)))

    bench("v3.dot", lambda x: x + vec.dot(v, w)[:, None] * 1e-9, v, n)
    bench("v3.cross", lambda x: vec.normalize(x + 1e-9 * vec.cross(x, w)), v, n)
    bench("quaternion.mul",
          lambda x: quat.normalize(quat.mul(x, q0)), q0, n)
    bench("quaternion.conj",
          lambda x: quat.normalize(quat.mul(quat.conj(x), q0)), q0, n)
    bench("quaternion.rotate (omega_i)",
          lambda x: vec.normalize(x + 1e-9 * quat.rotate(q0, x)), v, n)
    bench("quaternion.rotate_inv (world_ray)",
          lambda x: vec.normalize(x + 1e-9 * quat.rotate_inv(q0, x)), v, n)
    bench("shader_space.create",
          lambda x: vec.normalize(x + 1e-9 * shading.shader_quat(
              vec.normalize(x))[:, 1:]), v, n)
    bench("hemisphere sample",
          lambda x: vec.normalize(x + 1e-9 * shading.cosine_hemisphere(
              jnp.clip(x[:, 0], 0, 1), jnp.clip(x[:, 1], 0, 1))), v, n)

    # bbox slab test + point query (intersect_bench.ml:33-58: bbox
    # hit/miss and Bbox.mem are the reference's remaining microbenches)
    blo = jnp.asarray(rs.uniform(-10.0, 0.0, (n, 3)).astype(np.float32))
    bhi = blo + jnp.asarray(rs.uniform(0.5, 5.0, (n, 3)).astype(np.float32))
    pts = jnp.asarray(rs.uniform(-10.0, 5.0, (n, 3)).astype(np.float32))

    def bbox_slab(x):
        inv = 1.0 / x
        t0 = blo * inv  # ray origin at 0 (camera-space primaries)
        t1 = bhi * inv
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        hit = jnp.maximum(tn, 0.0) <= tf
        return vec.normalize(x + 1e-9 * hit[:, None])

    bench("bbox slab hit/miss", bbox_slab, v, n)

    def bbox_mem(x):
        inside = jnp.all((x >= blo) & (x <= bhi), axis=-1)
        return x + 1e-9 * inside[:, None]

    bench("bbox mem (point query)", bbox_mem, pts, n)

    # sampler
    s = Sampler(18)
    offs = jnp.arange(n, dtype=jnp.uint32)

    def lds_step(x):
        o = offs + x.astype(jnp.uint32)[:1]
        return x + s.get(o, 3)

    bench("lds.sample_fixed", lds_step, jnp.zeros((n,), jnp.float32), n)

    # sphere intersection (xla + triton kernel): 64k rays x 512 spheres
    S = 512
    centers = jnp.asarray(rs.uniform(-20, 20, (S, 3)).astype(np.float32))
    radii = jnp.asarray(rs.uniform(0.2, 2.0, S).astype(np.float32))
    valid = jnp.ones(S, bool)
    nr = 1 << 16
    org = jnp.zeros((nr, 3), jnp.float32)
    d0 = jnp.asarray(rs.randn(nr, 3).astype(np.float32))
    d0 = d0 / jnp.linalg.norm(d0, axis=1, keepdims=True)

    packed = spheres.pack_for_intersect(centers, radii, valid)

    def isect_xla(x):
        at, idx, hit, inv_a = spheres.intersect_packed(*packed, valid, org, x)
        return vec.normalize(x + 1e-12 * at[:, None])

    bench(f"sphere intersect xla ({S} sph)", isect_xla, d0, nr * S)

    if jax.default_backend() == "gpu":
        from pathtracer_tpu.ops.pallas import sphere_kernel as sk
        table = sk.pack_spheres(centers, radii, valid)

        def isect_kernel(x):
            at, idx, hit, inv_a = sk.intersect_spheres(table, org, x)
            return vec.normalize(x + 1e-12 * at[:, None])

        bench(f"sphere intersect triton ({S} sph)", isect_kernel, d0, nr * S)

    # film reconstruction conv
    from pathtracer_tpu import film
    k2 = film.binomial_kernel_2d(5, 1)
    img = jnp.asarray(rs.rand(512, 512, 3).astype(np.float32))
    bench("film 3x3 reconstruction (512^2)",
          lambda x: x + 1e-9 * film.apply_filter(x, k2), img, 512 * 512)


if __name__ == "__main__":
    main()
