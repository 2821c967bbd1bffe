"""Host-side SAH-builder benchmark: times the native C++ build (and the
walk-table fills) on random boxes and the committed 449k-tri ganesha
shell.

Usage: python tools/bench_bvh_build.py
"""
import time

import numpy as np

from pathtracer_tpu.io import ply
from pathtracer_tpu.native import bvh_build_native
from pathtracer_tpu.ops.bvh import build_walk_table8


def time_build(lo, hi, reps=3):
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = bvh_build_native(lo, hi, 8, 32, 1.0, 0.25, want_axes=True)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    rs = np.random.RandomState(5)
    for n in (70000, 200000):
        c = rs.uniform(-20, 20, (n, 3)).astype(np.float32)
        e = rs.uniform(0.005, 0.4, (n, 3)).astype(np.float32)
        dt, _ = time_build(np.ascontiguousarray(c - e),
                           np.ascontiguousarray(c + e))
        print(f"rand{n:7d}: build {dt*1e3:8.1f} ms")

    p = ply.load("scenes/big_ganesha.ply")
    v = np.stack([p.data["vertex"][k] for k in "xyz"], 1).astype(np.float32)
    f = p.data["vertex_indices"]["vertex_indices"]
    a, b, cc = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    lo = np.ascontiguousarray(np.minimum(np.minimum(a, b), cc))
    hi = np.ascontiguousarray(np.maximum(np.maximum(a, b), cc))
    dt, out = time_build(lo, hi)
    nodes_lo, nodes_hi, meta, order, depth, axes = out
    print(f"ganesha {len(lo)}: build {dt*1e3:8.1f} ms  depth={depth} "
          f"nodes={len(meta)}")
    ao, bo, co = a[order], b[order], cc[order]
    t0 = time.perf_counter()
    table, node_end, stride = build_walk_table8(nodes_lo, nodes_hi, meta,
                                                axes, ao, bo - ao, co - ao)
    print(f"ganesha bvh8 table fill: {(time.perf_counter()-t0)*1e3:8.1f} ms "
          f"({table.nbytes/1e6:.0f} MB)")


if __name__ == "__main__":
    main()
