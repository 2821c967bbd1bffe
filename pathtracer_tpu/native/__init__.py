"""Native (C++) runtime tier, loaded via ctypes.

Compiled on first use with g++ into this directory; callers fall back to the
pure-numpy implementations when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess

import numpy as np


def alloc_big(shape, dtype=np.float32):
    """Big writable array backed by a raw anonymous mmap instead of the
    process allocator. Once jaxlib initializes, its bundled allocator takes
    over malloc and madvises THP on large arenas — and 2 MB-page faults on
    this kernel run ~80x slower than 4 KB ones (73 MB: 3.9 s vs 0.08 s
    measured), which was silently taxing every big host-side table build.
    Raw mmap sidesteps the arena, keeping first-touch faults fast."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if n < (1 << 22):  # small arrays: the tax is negligible
        return np.empty(shape, dtype)
    buf = mmap.mmap(-1, n)
    return np.frombuffer(buf, dtype).reshape(shape)

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _compile(src, so):
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread", src,
         "-o", so + ".tmp"],
        check=True, capture_output=True)
    os.replace(so + ".tmp", so)


def _compile_and_load():
    src = os.path.join(_DIR, "bvh_build.cc")
    so = os.path.join(_DIR, "libbvh.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        _compile(src, so)
    try:
        lib = ctypes.CDLL(so)
        lib.bvh_build2  # stale-but-newer .so (e.g. after a checkout):
        lib.bvh_flatten_octants  # missing symbols force a rebuild
        lib.bvh4_table_rows
    except (OSError, AttributeError):
        _compile(src, so)
        lib = ctypes.CDLL(so)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.bvh_build.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_float, ctypes.c_float,
                              f32p, f32p, i32p, i32p, i32p]
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build2.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_float,
                               f32p, f32p, i32p, i32p, i32p, i32p]
    lib.bvh_build2.restype = ctypes.c_int
    lib.bvh_flatten_octants.argtypes = [i32p, i32p, ctypes.c_int,
                                        i32p, i32p, i32p]
    lib.bvh_flatten_octants.restype = None
    for w in (4, 8):
        rows_fn = getattr(lib, f"bvh{w}_table_rows")
        rows_fn.argtypes = [i32p, ctypes.c_int, i32p]
        rows_fn.restype = ctypes.c_int64
        fill_fn = getattr(lib, f"bvh{w}_table_fill")
        fill_fn.argtypes = [f32p, f32p, i32p, i32p, ctypes.c_int,
                            f32p, f32p, f32p, ctypes.c_int,
                            f32p, ctypes.c_int64, ctypes.c_int32]
        fill_fn.restype = None
    return lib


def get_lib():
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _compile_and_load()
        except Exception:
            _LIB = None
    return _LIB


def bvh_build_native(prim_lo, prim_hi, length_cutoff=8, num_bins=32,
                     cost_i=1.0, cost_t=0.25, want_axes=False):
    """C++ binned-SAH build; returns the same tuple as ops.bvh.build_bvh or
    None when the native library is unavailable. With want_axes=True the
    tuple gains a per-node split-axis array (-1 for leaves)."""
    lib = get_lib()
    if lib is None:
        return None
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    n = len(lo)
    cap = max(2 * n, 4)
    # alloc_big: mmap-backed buffers dodge the THP first-touch tax the
    # jaxlib allocator imposes on fresh multi-MB arenas (~1 s across
    # these outputs at 449k prims)
    nodes_lo = alloc_big((cap, 3), np.float32)
    nodes_hi = alloc_big((cap, 3), np.float32)
    meta = alloc_big((cap, 3), np.int32)
    order = alloc_big((n,), np.int32) if n else np.empty(0, np.int32)
    depth = np.zeros(1, np.int32)
    if want_axes:
        axes = alloc_big((cap,), np.int32)
        m = lib.bvh_build2(lo, hi, n, length_cutoff, num_bins,
                           np.float32(cost_i), np.float32(cost_t),
                           nodes_lo, nodes_hi, meta, order, depth, axes)
        return (nodes_lo[:m].copy(), nodes_hi[:m].copy(), meta[:m].copy(),
                order.astype(np.int64), int(depth[0]), axes[:m].copy())
    m = lib.bvh_build(lo, hi, n, length_cutoff, num_bins,
                      np.float32(cost_i), np.float32(cost_t),
                      nodes_lo, nodes_hi, meta, order, depth)
    return (nodes_lo[:m].copy(), nodes_hi[:m].copy(), meta[:m].copy(),
            order.astype(np.int64), int(depth[0]))


def _bvh_wide_table_native(width, nodes_lo, nodes_hi, meta, axes, tri_a,
                           tri_e1, tri_e2):
    """C++ BVH4/BVH8 walk-table build (8 octant fills on threads);
    returns (table (R,32) f32, node_end, stride) or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    meta = np.ascontiguousarray(meta, np.int32)
    axes = np.ascontiguousarray(axes, np.int32)
    m = meta.shape[0]
    stride = np.zeros(1, np.int32)
    rows = getattr(lib, f"bvh{width}_table_rows")(meta, m, stride)
    if width == 8 and rows * 8 >= 1 << 24:
        raise ValueError("mesh too large for 24-bit BVH8 entries")
    table = alloc_big((rows, 32), np.float32)
    getattr(lib, f"bvh{width}_table_fill")(
        np.ascontiguousarray(nodes_lo, np.float32),
        np.ascontiguousarray(nodes_hi, np.float32), meta, axes, m,
        np.ascontiguousarray(tri_a, np.float32),
        np.ascontiguousarray(tri_e1, np.float32),
        np.ascontiguousarray(tri_e2, np.float32),
        len(tri_a), table, rows, int(stride[0]))
    return table, 8 * int(stride[0]), int(stride[0])


def bvh4_table_native(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                      tri_e2):
    return _bvh_wide_table_native(4, nodes_lo, nodes_hi, meta, axes,
                                  tri_a, tri_e1, tri_e2)


def bvh8_table_native(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                      tri_e2):
    return _bvh_wide_table_native(8, nodes_lo, nodes_hi, meta, axes,
                                  tri_a, tri_e1, tri_e2)


def bvh_flatten_octants_native(meta, axes):
    """8 octant-ordered flattenings of a canonical skip-link tree; returns
    (perm, enter, skip) each (8, m) int32, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    meta = np.ascontiguousarray(meta, np.int32)
    axes = np.ascontiguousarray(axes, np.int32)
    m = meta.shape[0]
    perm = np.empty((8, m), np.int32)
    enter = np.empty((8, m), np.int32)
    skip = np.empty((8, m), np.int32)
    lib.bvh_flatten_octants(meta, axes, m, perm, enter, skip)
    return perm, enter, skip
