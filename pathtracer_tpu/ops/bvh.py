"""Bounding volume hierarchy: host-side binned-SAH build, flattened
skip-link layout, and a divergence-tolerant stackless traversal in XLA.

Build mirrors the reference's `Shape_tree` semantics (shape_tree.ml:82-195):
binned SAH over all 3 axes (default 32 bins), cost = costT + (Al*Nl +
Ar*Nr) * costI / Atotal with costI=1.0, costT=0.25; a node becomes a leaf
when count <= 4, or when the best split is no cheaper than leaving it whole
and count <= length_cutoff. (The exact tree shape doesn't affect images —
nearest-hit is unique — so bit-parity with the reference's partitioning is
not required; the cost model and cutoffs are the same.)

Flattening is depth-first with skip links, so traversal needs no stack:
  enter(i) = i+1 (when the ray hits node i's bbox and i is inner)
  skip(i)  = DFS index just past i's subtree (miss, or after a leaf)
Every lane walks its own node pointer in lockstep; leaf triangles are
tested with a masked fixed-width loop. Slab test per bbox.ml:40-56 with
shrinking t_max (shape_tree.ml:212-216).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

BIG = np.float32(3.0e38)


def _default_walk_caps(fallback=(64, 0)):
    """Multi-pass walk schedule; override with PATHTRACER_WALK_CAPS
    (comma-separated step caps, 0 = run to completion) for tuning.
    Malformed values fall back to the default: one capped pass, one
    resort and one uncapped pass. The caps are not yet tuned on the GPU."""
    import os
    env = os.environ.get("PATHTRACER_WALK_CAPS")
    if env:
        try:
            caps = tuple(int(x) for x in env.split(",") if x.strip())
            # a negative cap would make its pass a silent no-op that still
            # pays a resort; only the trailing 0 (= run to completion) is
            # a legal non-positive entry
            if caps and all(c > 0 for c in caps[:-1]) and caps[-1] >= 0:
                return caps
        except ValueError:
            pass
    return fallback


def build_bvh(prim_lo, prim_hi, length_cutoff=8, num_bins=32,
              cost_i=1.0, cost_t=0.25, native=True, want_axes=False):
    """Build from per-primitive bboxes. Returns (nodes_lo (M,3), nodes_hi
    (M,3), meta (M,3) int32 [first,count,skip], order (T,) primitive
    permutation, depth[, axes (M,) int32 when want_axes]).

    Uses the C++ builder (native/bvh_build.cc) when available — ~100x the
    python builder on large meshes — with this numpy version as the
    reference implementation and fallback. The two can produce different
    (equally valid) trees on bin ties: numpy's mask split is stable,
    std::partition is not. Tree shape never affects images (nearest-hit
    is unique), so tests assert IMAGE/intersection equality, not tree
    equality. The C++ builder parallelizes across subtrees above 65k
    primitives with output byte-identical to its serial path.
    """
    if native:
        from ..native import bvh_build_native
        out = bvh_build_native(prim_lo, prim_hi, length_cutoff, num_bins,
                               cost_i, cost_t, want_axes=want_axes)
        if out is not None:
            return out
    n = len(prim_lo)
    cent = 0.5 * (prim_lo + prim_hi)
    order = np.arange(n)
    nodes = []  # (lo, hi, first, count, skip_placeholder, axis)

    def node_bbox(idx):
        return prim_lo[idx].min(0), prim_hi[idx].max(0)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    max_depth = [0]

    def rec(idx, depth):
        max_depth[0] = max(max_depth[0], depth)
        lo, hi = node_bbox(idx)
        me = len(nodes)
        nodes.append([lo, hi, 0, 0, 0, -1])
        count = len(idx)
        if count <= 4:
            nodes[me][2:4] = [None, idx]  # leaf; resolved later
            return me
        # binned SAH over 3 axes (shape_tree.ml:82-146)
        c = cent[idx]
        best = None
        total_area = area(lo, hi)
        for axis in range(3):
            cmin, cmax = c[:, axis].min(), c[:, axis].max()
            if cmax - cmin < 1e-12:
                continue
            bins = np.clip(((c[:, axis] - cmin) / (cmax - cmin)
                            * num_bins).astype(np.int32), 0, num_bins - 1)
            counts = np.bincount(bins, minlength=num_bins)
            # prefix/suffix bbox areas
            bl = np.full((num_bins, 3), np.inf)
            bh = np.full((num_bins, 3), -np.inf)
            for b in range(num_bins):
                sel = bins == b
                if sel.any():
                    bl[b] = prim_lo[idx][sel].min(0)
                    bh[b] = prim_hi[idx][sel].max(0)
            pre_lo = np.minimum.accumulate(bl, 0)
            pre_hi = np.maximum.accumulate(bh, 0)
            suf_lo = np.minimum.accumulate(bl[::-1], 0)[::-1]
            suf_hi = np.maximum.accumulate(bh[::-1], 0)[::-1]
            nl = np.cumsum(counts)
            for b in range(num_bins - 1):
                if nl[b] == 0 or nl[b] == count:
                    continue
                al = area(pre_lo[b], pre_hi[b])
                ar = area(suf_lo[b + 1], suf_hi[b + 1])
                cost = cost_t + (al * nl[b] + ar * (count - nl[b])) * cost_i \
                    / max(total_area, 1e-30)
                if best is None or cost < best[0]:
                    best = (cost, axis, b, cmin, cmax)
        leaf_cost = count * cost_i
        sah_stop = best is not None and best[0] >= leaf_cost
        if count <= length_cutoff and (best is None or sah_stop):
            nodes[me][2:4] = [None, idx]
            return me
        if best is None:
            # degenerate centroids and too big for a leaf: median split;
            # ordered traversal wants SOME axis — longest bbox extent
            half = count // 2
            left_idx, right_idx = idx[:half], idx[half:]
            nodes[me][5] = int(np.argmax(hi - lo))
        else:
            _, axis, b, cmin, cmax = best
            bins = np.clip(((cent[idx][:, axis] - cmin) / (cmax - cmin)
                            * num_bins).astype(np.int32), 0, num_bins - 1)
            sel = bins <= b
            left_idx, right_idx = idx[sel], idx[~sel]
            nodes[me][5] = axis
        rec(left_idx, depth + 1)
        rec(right_idx, depth + 1)
        nodes[me][4] = len(nodes)  # skip = index past subtree
        return me

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        rec(order, 1)
    finally:
        sys.setrecursionlimit(old_limit)

    # resolve leaves: assign contiguous primitive ranges in DFS leaf order
    perm = []
    m = len(nodes)
    lo_arr = np.zeros((m, 3), np.float32)
    hi_arr = np.zeros((m, 3), np.float32)
    meta = np.zeros((m, 3), np.int32)
    axes_arr = np.zeros(m, np.int32)
    for i, (lo, hi, first, cnt, skip, ax) in enumerate(nodes):
        lo_arr[i] = lo
        hi_arr[i] = hi
        axes_arr[i] = ax
        if first is None:  # leaf: cnt holds the index array
            meta[i, 0] = len(perm)
            meta[i, 1] = len(cnt)
            meta[i, 2] = i + 1  # DFS next == skip for a leaf
            perm.extend(cnt.tolist())
        else:
            meta[i, 0] = 0
            meta[i, 1] = 0
            meta[i, 2] = skip
    out = (lo_arr, hi_arr, meta, np.asarray(perm), max_depth[0])
    return out + (axes_arr,) if want_axes else out


def flatten_octants(meta, axes, native=True):
    """8 octant-ordered DFS flattenings of a canonical skip-link tree:
    per octant o = (dx<0)<<2 | (dy<0)<<1 | (dz<0), children are emitted
    near-first by the ray-direction sign along each node's split axis.
    This is the reference's ordered descent (shape_tree.ml:198-220) recast
    for a lockstep wavefront: instead of a per-ray stack, the walk just
    starts each lane at its own octant's root row and chases precomputed
    skip links.

    Returns (perm, enter, skip), each (8, m) int32; perm maps new->canon
    index, enter is -(first+1) for leaves else the near-child new index,
    skip is the new index just past the subtree. C++ when available.
    """
    if native:
        from ..native import bvh_flatten_octants_native
        out = bvh_flatten_octants_native(meta, axes)
        if out is not None:
            return out
    import sys
    m = meta.shape[0]
    perm = np.empty((8, m), np.int32)
    enter = np.empty((8, m), np.int32)
    skip = np.empty((8, m), np.int32)
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        for o in range(8):
            cnt = [0]

            def rec(ci):
                ni = cnt[0]
                cnt[0] += 1
                perm[o, ni] = ci
                if meta[ci, 1] > 0:  # leaf
                    enter[o, ni] = -(meta[ci, 0] + 1)
                else:
                    left = ci + 1
                    right = meta[left, 2]
                    neg = (o >> (2 - axes[ci])) & 1
                    near, far = (right, left) if neg else (left, right)
                    enter[o, ni] = rec(near)
                    rec(far)
                skip[o, ni] = cnt[0]
                return ni

            if m:
                rec(0)
    finally:
        sys.setrecursionlimit(old_limit)
    return perm, enter, skip


def build_walk_table(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1, tri_e2):
    """Assemble the unified gather table for the octant-ordered walk.

    One (R, 16) f32 array holding BOTH node rows and triangle rows, so each
    walk iteration issues exactly ONE row gather (the old walk needed six:
    meta/lo/hi/a/e1/e2 — on a gather-bound loop that is the bill). Rows:

      node rows  [0, 8m):  [lo xyz, hi xyz, enter_bits, skip_bits, 0...]
                 octant o's flattening occupies rows [o*m, (o+1)*m); all
                 its pointers stay inside the slice or jump to tri rows,
                 so the walk never needs to know the octant after lane
                 init. enter = near-child row (inner) or 8m+first (leaf);
                 skip = subtree-miss row or DONE.
      tri rows   [8m, 8m+T): [a xyz, e1 xyz, e2 xyz, idx_bits, is_last, ...]
                 chained: next = row+1, or (is_last) the walk's carried
                 leaf-return register. Shared by all 8 octants.
      DONE row   R-1: all-zero dummy (det==0 never hits); absorbing.

    Int columns are raw int32 bits stored via np view / lax.bitcast — the
    gather moves bits, never interprets them as floats.
    """
    m = meta.shape[0]
    perm, enter, skip = flatten_octants(meta, axes)
    tri_a = np.asarray(tri_a, np.float32)
    tri_e1 = np.asarray(tri_e1, np.float32)
    tri_e2 = np.asarray(tri_e2, np.float32)
    t_cnt = tri_a.shape[0]
    node_end = 8 * m
    rows = node_end + t_cnt + 1
    done = rows - 1
    table = np.zeros((rows, 16), np.float32)
    ti = table.view(np.int32)

    p = perm.reshape(-1).astype(np.int64)
    table[:node_end, 0:3] = nodes_lo[p]
    table[:node_end, 3:6] = nodes_hi[p]
    oct_off = np.arange(8, dtype=np.int32)[:, None] * m
    is_leaf = enter < 0
    enter_rows = np.where(is_leaf, node_end + (-enter - 1), enter + oct_off)
    skip_rows = np.where(skip >= m, done, skip + oct_off)
    ti[:node_end, 6] = enter_rows.reshape(-1)
    ti[:node_end, 7] = skip_rows.reshape(-1)

    tr = slice(node_end, node_end + t_cnt)
    table[tr, 0:3] = tri_a
    table[tr, 3:6] = tri_e1
    table[tr, 6:9] = tri_e2
    ti[tr, 9] = np.arange(t_cnt, dtype=np.int32)
    last = np.zeros(t_cnt, np.float32)
    lm = meta[:, 1] > 0
    last[meta[lm, 0] + meta[lm, 1] - 1] = 1.0
    table[tr, 10] = last
    return table, node_end, m


def _collapse4_elements(meta, ci):
    """The (up to 4) collapsed-BVH4 elements of binary inner node ci: each
    binary child contributes itself (leaf) or its two children (inner).
    Octant-independent — ordering happens at emit time."""
    left = ci + 1
    right = meta[left, 2]
    els = []
    for y in (left, right):
        if meta[y, 1] > 0:  # leaf
            els.append(y)
        else:
            yl = y + 1
            els.extend((yl, meta[yl, 2]))
    return els


def build_walk_table4(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                      tri_e2, native=True):
    """Assemble the BVH4 re-entry walk table: one (R, 32) f32 array where
    each gathered node row resolves FOUR slab tests (vs one for the
    16-col binary table) and each triangle row tests TWO triangles.

    Pointers are PHASE-ENCODED: ptr = row*4 + phase (phase = first child
    slot still to consider). A child's subtree exit returns to its
    PARENT's row at phase i+1, so the parent re-tests its remaining
    children against the *current* (possibly shrunken) t_best and jumps
    straight to the next hit child — the reference's shrinking-t_max
    ordered descent (shape_tree.ml:198-220) without a stack and without
    static sibling chains (chaining siblings statically spends lane-steps
    entering trailing siblings that were already missed).

      node rows [0, stride*8): octant o owns rows [o*stride,(o+1)*stride):
        cols [6i, 6i+6) = child i's (lo,hi) in the octant's near-first
        order (NaN-padded past arity; NaN slab tests never hit); int col
        24+i = child i's entry ptr (inner child's row*4, or the leaf's
        first tri-pair row*4); col 28 = this node's exit ptr; col 29 =
        arity. Entering a leaf child i sets the carried leaf-return
        register to (row*4 + i+1), or to the exit ptr when i is the last
        child. No guard rows: leaves are entered directly.
      tri rows [stride*8, stride*8 + P): TWO triangles per row, chained
        per leaf by ptr+4; cols 0-8 tri0 (a,e1,e2), 9 idx0 bits, 10
        is_last, 12-20 tri1, 21 idx1 bits. Odd leaves pad tri1 with
        zeros (det==0 never hits). Shared by all 8 octants.
      DONE row R-1: absorbing all-zero row (ptr == (R-1)*4).

    Returns (table, node_end, stride) — node_end/stride in ROW units."""
    if native:
        from ..native import bvh4_table_native
        out = bvh4_table_native(nodes_lo, nodes_hi, meta, axes, tri_a,
                                tri_e1, tri_e2)
        if out is not None:
            return out
    m = meta.shape[0]
    tri_a = np.asarray(tri_a, np.float32)
    tri_e1 = np.asarray(tri_e1, np.float32)
    tri_e2 = np.asarray(tri_e2, np.float32)

    # tri-pair rows per leaf (pairs never span leaves)
    leaf_ids = np.nonzero(meta[:, 1] > 0)[0]
    pair_first = np.zeros(m, np.int64)
    pr = 0
    for ci in leaf_ids:
        pair_first[ci] = pr
        pr += (int(meta[ci, 1]) + 1) // 2
    n_pairs = pr

    # subtree row counts (octant-independent): leaf element -> 0 (entered
    # directly, no guard); inner -> 1 + sum of elements
    size4 = np.zeros(m, np.int64)

    def compute_size(ci):
        # iterative post-order to dodge recursion limits on deep trees
        stack = [(ci, False)]
        while stack:
            node, ready = stack.pop()
            if meta[node, 1] > 0:
                size4[node] = 0
                continue
            els = _collapse4_elements(meta, node)
            if ready:
                size4[node] = 1 + sum(size4[e] for e in els)
            else:
                stack.append((node, True))
                stack.extend((e, False) for e in els)

    if m:
        compute_size(0)
    # a leaf root still needs one node row per octant to set lret
    stride = max(int(size4[0]), 1) if m else 1
    node_end = 8 * stride
    rows = node_end + n_pairs + 1
    done = rows - 1
    done_ptr = 4 * done
    table = np.full((rows, 32), np.nan, np.float32)
    ti = table.view(np.int32)

    def near_order(parent, o):
        """Octant o's near-first order of parent's elements: outer order by
        parent's split axis sign, inner order by each expanded child's own
        axis."""
        left = parent + 1
        right = meta[left, 2]
        out = []
        for y in ((right, left) if (o >> (2 - axes[parent])) & 1
                  else (left, right)):
            if meta[y, 1] > 0:
                out.append(y)
            else:
                yl = y + 1
                yr = meta[yl, 2]
                out.extend((yr, yl) if (o >> (2 - axes[y])) & 1
                           else (yl, yr))
        return out

    for o in range(8):
        base = o * stride
        # iterative DFS: (binary_node, row, exit_ptr[phase-encoded])
        stack = [(0, base, done_ptr)] if m else []
        while stack:
            ci, row, exit_ptr = stack.pop()
            if meta[ci, 1] > 0:  # leaf root: degenerate 1-child node row
                table[row, 0:3] = nodes_lo[ci]
                table[row, 3:6] = nodes_hi[ci]
                ti[row, 24] = 4 * (node_end + pair_first[ci])
                ti[row, 25:28] = done_ptr
                ti[row, 28] = exit_ptr
                ti[row, 29] = 1
                continue
            els = near_order(ci, o)
            k = len(els)
            entry = row + 1
            ti[row, 24:28] = done_ptr
            for i, e in enumerate(els):
                table[row, 6 * i:6 * i + 3] = nodes_lo[e]
                table[row, 6 * i + 3:6 * i + 6] = nodes_hi[e]
                ex = exit_ptr if i == k - 1 else 4 * row + i + 1
                if meta[e, 1] > 0:  # leaf child: direct tri entry
                    ti[row, 24 + i] = 4 * (node_end + pair_first[e])
                else:
                    ti[row, 24 + i] = 4 * entry
                    stack.append((e, entry, ex))
                    entry += int(size4[e])
            ti[row, 28] = exit_ptr
            ti[row, 29] = k

    # tri pair rows
    tp = np.zeros((n_pairs, 32), np.float32)
    tpi = tp.view(np.int32)
    for ci in leaf_ids:
        f, n = int(meta[ci, 0]), int(meta[ci, 1])
        p0 = pair_first[ci]
        for k, j in enumerate(range(0, n, 2)):
            r = p0 + k
            tp[r, 0:3] = tri_a[f + j]
            tp[r, 3:6] = tri_e1[f + j]
            tp[r, 6:9] = tri_e2[f + j]
            tpi[r, 9] = f + j
            if j + 1 < n:
                tp[r, 12:15] = tri_a[f + j + 1]
                tp[r, 15:18] = tri_e1[f + j + 1]
                tp[r, 18:21] = tri_e2[f + j + 1]
                tpi[r, 21] = f + j + 1
            tp[r, 10] = 1.0 if j + 2 >= n else 0.0
    table[node_end:node_end + n_pairs] = tp
    table[done] = 0.0
    return table, node_end, stride


def build_walk_table8(nodes_lo, nodes_hi, meta, axes, tri_a, tri_e1,
                      tri_e2, native=True):
    """Assemble the BVH8 re-entry walk table: same phase-encoded re-entry
    walk as build_walk_table4 but collapsing THREE binary levels per row,
    still in (R, 32) f32 rows: a walk step costs mostly a fixed per-step
    overhead plus the row's bytes, so resolving 8 boxes per gather at
    unchanged row width cuts the step count.

    Child boxes are quantized CWBVH-style relative to the row's own
    frame (an absolute-bf16 first cut inflated deep-leaf boxes ~2x:
    bf16 granularity is absolute while deep boxes are tiny). Row packing
    (int32 view):
      cols 0-2: frame origin (node bbox lo, f32); cols 3-5: per-axis
        scale = extent/254 (f32).
      cols 6-17: 48 uint8 quantized bounds: byte 2*(3i+a) = child i
        axis a qlo (rounded down, -1 quantum guard), byte 2*(3i+a)+1 =
        qhi (rounded up, +1 quantum guard); decode b = origin + q*scale.
        Conservative: loose boxes cost extra entries, never miss. Empty
        slots are inverted (qlo=255 > qhi=0) so they can never pass the
        slab test.
      cols 18..23: 8 entry pointers, 24-bit little-endian packed; entry
        ptrs are (row*8) so bit0 carries the last-child flag.
      col 24: exit ptr (phase-encoded).
      cols 26-28: reciprocal scale (f32, = 1/cols 3-5), filled by the
        post-pass below for BOTH builder paths: the walker tests slabs in
        the row's QUANTIZED frame (ray origin mapped once per step via
        rscale; t = (q - po) * (inv_d * scale)) instead of decoding all
        48 world-space bounds — saves ~48 FMAs per lane-step. The ±1
        quantum guard band dwarfs the extra fp rounding, so visit sets
        only change on measure-zero tangent grazes.
    Tri rows and pointer semantics otherwise match build_walk_table4
    with phase = ptr & 7, row = ptr >> 3.

    Returns (table, node_end, stride) in ROW units. Requires
    rows*8 < 2^24 (24-bit entries) — callers fall back to the BVH4
    table beyond that (~2M rows ~= 8M tris)."""
    def with_rscale(table, node_end, stride):
        # node rows only; tri rows keep cols 22-31 free/zero. Unwritten
        # rows (empty-mesh padding) keep 0 — they are never visited.
        sc = table[:node_end, 3:6]
        table[:node_end, 26:29] = np.divide(
            np.float32(1.0), sc, out=np.zeros_like(sc), where=sc > 0)
        return table, node_end, stride

    if native:
        from ..native import bvh8_table_native
        out = bvh8_table_native(nodes_lo, nodes_hi, meta, axes, tri_a,
                                tri_e1, tri_e2)
        if out is not None:
            return with_rscale(*out)
    m = meta.shape[0]
    tri_a = np.asarray(tri_a, np.float32)
    tri_e1 = np.asarray(tri_e1, np.float32)
    tri_e2 = np.asarray(tri_e2, np.float32)

    leaf_ids = np.nonzero(meta[:, 1] > 0)[0]
    pair_first = np.zeros(m, np.int64)
    pr = 0
    for ci in leaf_ids:
        pair_first[ci] = pr
        pr += (int(meta[ci, 1]) + 1) // 2
    n_pairs = pr

    def elements8(ci, o=None):
        """up-to-8 collapsed elements; octant-ordered when o is given."""
        els = []

        def expand(y, depth):
            if depth == 0 or meta[y, 1] > 0:
                els.append(y)
                return
            yl = y + 1
            yr = meta[yl, 2]
            if o is not None and (o >> (2 - axes[y])) & 1:
                yl, yr = yr, yl
            expand(yl, depth - 1)
            expand(yr, depth - 1)

        left, right = ci + 1, meta[ci + 1, 2]
        if o is not None and (o >> (2 - axes[ci])) & 1:
            left, right = right, left
        expand(left, 2)
        expand(right, 2)
        return els

    size8 = np.zeros(m, np.int64)
    if m:
        stack = [(0, False)]
        while stack:
            node, ready = stack.pop()
            if meta[node, 1] > 0:
                size8[node] = 0
                continue
            els = elements8(node)
            if ready:
                size8[node] = 1 + sum(size8[e] for e in els)
            else:
                stack.append((node, True))
                stack.extend((e, False) for e in els)

    stride = max(int(size8[0]), 1) if m else 1
    node_end = 8 * stride
    rows = node_end + n_pairs + 1
    if rows * 8 >= 1 << 24:
        raise ValueError("mesh too large for 24-bit BVH8 entries")
    done = rows - 1
    done_ptr = 8 * done
    table = np.zeros((rows, 32), np.float32)
    ti = table.view(np.int32)
    nodes_lo = np.asarray(nodes_lo, np.float32)
    nodes_hi = np.asarray(nodes_hi, np.float32)

    def put_row(row, frame_ci, els, ev, exit_ptr):
        """els: up-to-8 child binary nodes; ev: 8 uint entries."""
        flo = nodes_lo[frame_ci]
        fhi = nodes_hi[frame_ci]
        scale = np.maximum(fhi - flo, np.float32(1e-30)) / np.float32(254.0)
        table[row, 0:3] = flo
        table[row, 3:6] = scale
        qb = np.zeros(48, np.uint8)
        qb[0::2] = 255  # empty slots: inverted box never passes the slab
        for i, e in enumerate(els):
            clo, chi = nodes_lo[e], nodes_hi[e]
            for a in range(3):
                ql = int(np.floor((clo[a] - flo[a]) / scale[a])) - 1
                qh = int(np.ceil((chi[a] - flo[a]) / scale[a])) + 1
                ql = min(max(ql, 0), 255)
                qh = min(max(qh, 0), 255)
                while ql > 0 and flo[a] + np.float32(ql) * scale[a] > clo[a]:
                    ql -= 1
                while qh < 255 and flo[a] + np.float32(qh) * scale[a] < chi[a]:
                    qh += 1
                qb[2 * (3 * i + a)] = ql
                qb[2 * (3 * i + a) + 1] = qh
        ti[row, 6:18] = qb.view(np.uint32).view(np.int32)
        by = np.zeros(24, np.uint8)
        for i in range(8):
            by[3 * i] = ev[i] & 0xFF
            by[3 * i + 1] = (ev[i] >> 8) & 0xFF
            by[3 * i + 2] = (ev[i] >> 16) & 0xFF
        ti[row, 18:24] = by.view(np.uint32).view(np.int32)
        ti[row, 24] = exit_ptr
        # arity masks unused slots out of the slab test (min/max slab is
        # symmetric in lo/hi, so an inverted box would NOT miss)
        ti[row, 25] = len(els)

    for o in range(8):
        base = o * stride
        stack = [(0, base, done_ptr)] if m else []
        while stack:
            ci, row, exit_ptr = stack.pop()
            ev = [done_ptr & 0xFFFFFF] * 8
            if meta[ci, 1] > 0:  # leaf root: degenerate 1-child row
                ev[0] = (8 * (node_end + pair_first[ci])) | 1
                put_row(row, ci, [ci], ev, exit_ptr)
                continue
            els = elements8(ci, o)
            k = len(els)
            entry = row + 1
            for i, e in enumerate(els):
                last = 1 if i == k - 1 else 0
                ex = exit_ptr if i == k - 1 else 8 * row + i + 1
                if meta[e, 1] > 0:
                    ev[i] = (8 * (node_end + pair_first[e])) | last
                else:
                    ev[i] = (8 * entry) | last
                    stack.append((e, entry, ex))
                    entry += int(size8[e])
            put_row(row, ci, els, ev, exit_ptr)

    # tri pair rows: identical layout to the BVH4 table
    for ci in leaf_ids:
        f, n = int(meta[ci, 0]), int(meta[ci, 1])
        p0 = node_end + pair_first[ci]
        for k2, j in enumerate(range(0, n, 2)):
            r = p0 + k2
            table[r, 0:3] = tri_a[f + j]
            table[r, 3:6] = tri_e1[f + j]
            table[r, 6:9] = tri_e2[f + j]
            ti[r, 9] = f + j
            if j + 1 < n:
                table[r, 12:15] = tri_a[f + j + 1]
                table[r, 15:18] = tri_e1[f + j + 1]
                table[r, 18:21] = tri_e2[f + j + 1]
                ti[r, 21] = f + j + 1
            table[r, 10] = 1.0 if j + 2 >= n else 0.0
    table[done] = 0.0
    return with_rscale(table, node_end, stride)


def leaf_histogram(meta):
    """leaf size -> count (the reference's leaf_length_histogram,
    shape_tree.ml:238-247)."""
    sizes = meta[meta[:, 1] > 0, 1]
    hist = {}
    for s in sizes:
        hist[int(s)] = hist.get(int(s), 0) + 1
    return dict(sorted(hist.items()))


def _coherence_key_fn(root_lo_np, root_hi_np):
    """Sort key grouping rays that will walk similar subtrees: direction
    octant (3b) + quantized direction Morton (15b) + origin-cell Morton
    (12b). Chunk cost is its own worst lane, so coherent chunks make
    worst ~= mean (same load-balance idea as the PPM gather sort);
    inactive lanes sort to one tail chunk that exits immediately."""
    from .photon_chunks import morton3
    # HOST numpy, not device arrays: closed-over device arrays lower into
    # MLIR constants via a device->host copy (see ops/lds.Sampler)
    root_lo = np.asarray(root_lo_np, np.float32)
    root_inv_ext = np.asarray(
        1.0 / np.maximum(np.asarray(root_hi_np) - np.asarray(root_lo_np),
                         1e-9), np.float32)

    # PATHTRACER_WALK_KEY picks the bit priority (tuning knob):
    #   dir (default) — direction octant + dir morton over origin cell:
    #     primary/eye rays share origins, so direction is the signal
    #   org — fine origin morton first: secondary/photon rays scatter
    #     from surface points, and nearby origins walk the same deep
    #     subtree regardless of direction
    variant = os.environ.get("PATHTRACER_WALK_KEY", "dir")

    def key(org, d, active):
        oct_ = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
                + (d[:, 2] < 0)).astype(jnp.int32)
        dn = d * jax.lax.rsqrt(jnp.maximum(jnp.sum(d * d, 1, keepdims=True),
                                           1e-30))
        if variant == "org":
            oq = jnp.clip((org - root_lo) * root_inv_ext * 127.0, 0,
                          127).astype(jnp.int32)
            om = morton3(oq[:, 0], oq[:, 1], oq[:, 2])  # 21 bits
            q = jnp.clip(((dn + 1.0) * 1.99), 0, 3).astype(jnp.int32)
            dm = morton3(q[:, 0], q[:, 1], q[:, 2])  # 6 bits
            key = (om << 9) | (oct_ << 6) | dm
        elif variant == "om30":
            # finest origin morton alone (10 bits/axis = morton3's cap):
            # photon rays scatter from surface points, and the subtree a
            # lane walks is set almost entirely by WHERE it starts — the
            # NOTES' "sort by the 30-bit morton key" candidate
            oq = jnp.clip((org - root_lo) * root_inv_ext * 1023.0, 0,
                          1023).astype(jnp.int32)
            key = morton3(oq[:, 0], oq[:, 1], oq[:, 2])  # 30 bits
        elif variant == "om27oct":
            # 27-bit origin morton with direction octant as the tiebreak
            # WITHIN a cell (fits int32 with the 2^30 inactive sentinel)
            oq = jnp.clip((org - root_lo) * root_inv_ext * 511.0, 0,
                          511).astype(jnp.int32)
            om = morton3(oq[:, 0], oq[:, 1], oq[:, 2])  # 27 bits
            key = (om << 3) | oct_
        elif variant == "octorg":
            oq = jnp.clip((org - root_lo) * root_inv_ext * 127.0, 0,
                          127).astype(jnp.int32)
            om = morton3(oq[:, 0], oq[:, 1], oq[:, 2])  # 21 bits
            key = (oct_ << 21) | om
        else:
            q = jnp.clip(((dn + 1.0) * 15.5), 0, 31).astype(jnp.int32)
            dm = morton3(q[:, 0], q[:, 1], q[:, 2])  # 15 bits
            oq = jnp.clip((org - root_lo) * root_inv_ext * 15.0, 0,
                          15).astype(jnp.int32)
            om = morton3(oq[:, 0], oq[:, 1], oq[:, 2])  # 12 bits
            key = (oct_ << 27) | (dm << 12) | om
        return jnp.where(active, key, jnp.int32(2 ** 30))

    return key


_MT_EPS = np.float32(1e-6)


def _mt_update(org, d, rows, rows_i, a_sl, e1_sl, e2_sl, idx_col, best,
               is_tri):
    """Moller-Trumbore against a triangle stored in walk-table row columns,
    returning the updated (t, u, v, idx) best tuple where `is_tri` lanes
    accept. ONE definition shared by the octant/BVH4/BVH8 walkers so the
    epsilon and acceptance predicate (match ops/triangles.py;
    triangle.ml:74-98) cannot silently diverge between them."""
    t_best, u_best, v_best, i_best = best
    a = rows[:, a_sl]
    e1 = rows[:, e1_sl]
    e2 = rows[:, e2_sl]
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    det_inv = 1.0 / det
    tvec = org - a
    uu = det_inv * jnp.sum(tvec * pvec, axis=-1)
    qvec = jnp.cross(tvec, e1)
    vv = det_inv * jnp.sum(d * qvec, axis=-1)
    tt = det_inv * jnp.sum(e2 * qvec, axis=-1)
    ok = (is_tri & (jnp.abs(det) >= _MT_EPS) & (uu >= 0.0)
          & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt >= 0.0) & (tt <= t_best))
    return (jnp.where(ok, tt, t_best), jnp.where(ok, uu, u_best),
            jnp.where(ok, vv, v_best),
            jnp.where(ok, rows_i[:, idx_col], i_best))


def _chunked_walk_driver(init_state, walk_pass, key_fn, table_default,
                         done, default_caps=(64, 0), default_chunk=512):
    """The chunked + coherence-sorted + capped-multi-pass walk driver,
    shared by the binary-octant and BVH4 traversers (the two differ only
    in per-step row interpretation). See make_mesh_traverser_octant's
    intersect docstring for the rationale of chunk/caps."""

    def one(table_j, org, d, t_max0, active):
        state = walk_pass(table_j, org, d, init_state(d, t_max0, active), 0)
        _, _, t, u, v, idx = state
        hit = t < jnp.minimum(t_max0, BIG)
        return t, u, v, idx, hit

    def intersect(org, d, t_max0=None, active=None, chunk=None, table=None,
                  caps=None):
        n = org.shape[0]
        if t_max0 is None:
            t_max0 = jnp.full((n,), BIG)
        if active is None:
            active = jnp.ones((n,), bool)
        if chunk is None:
            chunk = default_chunk
        env_chunk = os.environ.get("PATHTRACER_WALK_CHUNK")
        if env_chunk:  # tuning knob; malformed values ignored
            try:
                chunk = max(0, int(env_chunk))
            except ValueError:
                pass
        if caps is None:
            caps = _default_walk_caps(default_caps)
        if not caps or caps[-1] != 0:
            caps = tuple(caps) + (0,)  # completion is not optional
        tbl = table_default if table is None else table
        if not (chunk and n > chunk):
            return one(tbl, org, d, t_max0, active)

        # sort by the static coherence key, pad to a chunk multiple
        perm = jnp.argsort(key_fn(org, d, active))
        # one plane-major gather for the 8-plane payload (see permute_all)
        pl8 = jnp.stack([org[:, 0], org[:, 1], org[:, 2], d[:, 0],
                         d[:, 1], d[:, 2], t_max0,
                         active.astype(jnp.float32)])[:, perm]
        org = jnp.stack([pl8[0], pl8[1], pl8[2]], axis=1)
        d = jnp.stack([pl8[3], pl8[4], pl8[5]], axis=1)
        t_max0, active = pl8[6], pl8[7] > 0.5
        lane_id = perm.astype(jnp.int32)
        pad = (-n) % chunk
        if pad:
            org = jnp.concatenate([org, jnp.zeros((pad, 3), org.dtype)])
            d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
            t_max0 = jnp.concatenate([t_max0,
                                      jnp.zeros((pad,), t_max0.dtype)])
            active = jnp.concatenate([active, jnp.zeros((pad,), bool)])
            lane_id = jnp.concatenate([lane_id,
                                       jnp.full((pad,), n, jnp.int32)])
        n_tot = n + pad
        state = init_state(d, t_max0, active)

        def run_chunked(cap, org, d, state):
            rsh = lambda x: x.reshape(-1, chunk, *x.shape[1:])
            out = lax.map(
                lambda a: walk_pass(tbl, a[0], a[1], tuple(a[2]), cap),
                (rsh(org), rsh(d), tuple(rsh(s) for s in state)))
            return tuple(o.reshape(n_tot) for o in out)

        def permute_all(p, org, d, t_max0, lane_id, state):
            # ONE plane-major gather for the whole 14-plane lane payload
            # instead of fourteen narrow (n,) gathers. Bitcasts move bits
            # verbatim, so int planes survive the f32 stack exactly.
            bc = lambda a: lax.bitcast_convert_type(a, jnp.float32)
            ub = lambda a: lax.bitcast_convert_type(a, jnp.int32)
            planes = jnp.stack(
                [org[:, 0], org[:, 1], org[:, 2], d[:, 0], d[:, 1],
                 d[:, 2], t_max0, bc(lane_id), bc(state[0]), bc(state[1]),
                 state[2], state[3], state[4], bc(state[5])])[:, p]
            org = jnp.stack([planes[0], planes[1], planes[2]], axis=1)
            d = jnp.stack([planes[3], planes[4], planes[5]], axis=1)
            state = (ub(planes[8]), ub(planes[9]), planes[10], planes[11],
                     planes[12], ub(planes[13]))
            return org, d, planes[6], ub(planes[7]), state

        for pi, cap in enumerate(caps):
            if pi:  # regroup: finished lanes last, survivors by ptr
                key2 = jnp.where(state[0] == done, jnp.int32(2 ** 30),
                                 state[0])
                p2 = jnp.argsort(key2)
                org, d, t_max0, lane_id, state = permute_all(
                    p2, org, d, t_max0, lane_id, state)
            state = run_chunked(cap, org, d, state)

        t, u, v, idx = state[2], state[3], state[4], state[5]
        hit = t < jnp.minimum(t_max0, BIG)
        # Undo the travelling lane permutation by scatter-inverting
        # lane_id instead of a second full argsort: lane_id holds each slot's ORIGINAL index, unique in
        # [0, n) for real lanes; pad slots share lane_id == n and drop.
        pos = jnp.zeros((n,), jnp.int32).at[lane_id].set(
            jnp.arange(n_tot, dtype=jnp.int32), mode="drop")
        bc = lambda a: lax.bitcast_convert_type(a, jnp.float32)
        out = jnp.stack([t, u, v, bc(idx),
                         hit.astype(jnp.float32)])[:, pos]
        return (out[0], out[1], out[2],
                lax.bitcast_convert_type(out[3], jnp.int32), out[4] > 0.5)

    return intersect


def make_mesh_traverser_bvh8(table_np, node_end, stride, root_lo, root_hi):
    """intersect(...) over the BVH8 re-entry walk table (layout:
    build_walk_table8). One 32-col gather resolves EIGHT bf16 slab tests
    (node row) or 2 Moller-Trumbore tests (tri-pair row); subtree exits
    re-enter the parent at the next child phase (phase = ptr & 7)."""
    table_default = jnp.asarray(table_np)
    rows_total = table_np.shape[0]
    done = 8 * (rows_total - 1)
    node_end8 = 8 * node_end
    key_fn = _coherence_key_fn(root_lo, root_hi)

    def init_state(d, t_max0, active):
        n = d.shape[0]
        oct_ = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
                + (d[:, 2] < 0)).astype(jnp.int32)
        ptr0 = jnp.where(active, oct_ * (8 * stride), done)
        return (ptr0, jnp.full((n,), done, jnp.int32),
                jnp.minimum(t_max0, BIG), jnp.zeros((n,)), jnp.zeros((n,)),
                jnp.zeros((n,), jnp.int32))

    def walk_pass(table_j, org, d, state, cap):
        inv_d = 1.0 / d
        # 2 walk steps per while iteration: the loop machinery (cond
        # scalar-sync + body dispatch) dominates the per-step fixed cost
        # on this device, and an extra body on an all-done state is the
        # identity, so unrolling stays bit-exact (caps round up to a
        # multiple of the unroll). PATHTRACER_WALK_UNROLL sweeps it.
        # NOTE: read at TRACE time — once the jit cache is warm for a
        # shape, changing it in-process has no effect (use fresh
        # processes for sweeps). Values outside [1, 16] are ignored:
        # each unroll step clones the whole body into the traced graph,
        # so an unbounded value would explode trace/compile time.
        unroll = 2
        env_u = os.environ.get("PATHTRACER_WALK_UNROLL")
        if env_u:  # tuning knob; malformed values ignored
            try:
                v = int(env_u)
                if 1 <= v <= 16:
                    unroll = v
            except ValueError:
                pass

        def cond(sk):
            state, k = sk
            live = jnp.any(state[0] != done)
            return (live & (k < cap)) if cap else live

        def body_k(sk):
            state, k = sk
            for _ in range(unroll):
                state = body(state)
            return state, k + unroll

        def body(state):
            ptr, lret, t_best, u_best, v_best, i_best = state
            row_idx = ptr >> 3
            phase = ptr & 7
            rows = table_j[row_idx]  # (n, 32): the one gather per step
            rows_i = lax.bitcast_convert_type(rows, jnp.int32)
            is_node = ptr < node_end8

            # node interpretation: slab test in the row's QUANTIZED frame
            # (origin cols 0-2, scale cols 3-5, rscale cols 26-28, uint8
            # bounds cols 6-17; empty slots are inverted boxes that never
            # pass). Mapping the ray once per step — po = (org - origin)
            # * rscale, id' = inv_d * scale — replaces decoding all 48
            # world-space bounds (origin + q*scale), ~48 fewer FMAs/step;
            # the ±1 quantum guard bands absorb the changed fp rounding.
            w = rows_i[:, 6:18]
            qbytes = [lax.shift_right_logical(w[:, c], np.int32(s)) & 0xFF
                      for c in range(12) for s in (0, 8, 16, 24)]
            qs = jnp.stack(qbytes, axis=1).astype(jnp.float32)  # (n,48)
            qlo = qs[:, 0::2].reshape(-1, 8, 3)
            qhi = qs[:, 1::2].reshape(-1, 8, 3)
            origin = rows[:, 0:3]
            scale = rows[:, 3:6]
            po = (org - origin) * rows[:, 26:29]
            idp = inv_d * scale
            t0 = (qlo - po[:, None, :]) * idp[:, None, :]
            t1 = (qhi - po[:, None, :]) * idp[:, None, :]
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            iota8 = jnp.arange(8, dtype=jnp.int32)[None, :]
            bh = jnp.maximum(tn, 0.0) <= jnp.minimum(tf, t_best[:, None])
            bh = bh & (iota8 >= phase[:, None]) \
                & (iota8 < rows_i[:, 25][:, None])
            any_hit = jnp.any(bh, axis=1) & is_node
            sel = jnp.argmax(bh, axis=1)  # first hit child (near order)

            # unpack all 8 24-bit entries with STATIC shift amounts, then
            # select by a where-chain instead of per-lane dynamic shifts
            # or column gathers
            w24 = [rows_i[:, 18 + c] for c in range(6)]
            evals = []
            for i in range(8):
                bo = 3 * i
                c, sh = bo >> 2, (bo & 3) * 8
                v = lax.shift_right_logical(w24[c], np.int32(sh)) \
                    if sh else w24[c]
                if sh > 8:
                    v = v | (w24[c + 1] << np.int32(32 - sh))
                evals.append(v & 0xFFFFFF)
            raw = evals[0]
            for i in range(1, 8):
                raw = jnp.where(sel == i, evals[i], raw)
            e_sel = raw & ~7
            skp = rows_i[:, 24]
            nxt_node = jnp.where(any_hit, e_sel, skp)
            # leaf-child return: re-enter this row at phase sel+1 only if
            # some LATER sibling still hits under the current t_best;
            # otherwise skip the re-entry step entirely (subsumes the
            # last-child case)
            beyond = jnp.any(bh & (iota8 > sel[:, None]), axis=1)
            exit_sel = jnp.where(beyond, (ptr & ~7) + sel + 1, skp)

            # tri-pair interpretation: tri0 then tri1 vs updated t_best
            is_tri = ~is_node
            best = (t_best, u_best, v_best, i_best)
            best = _mt_update(org, d, rows, rows_i, slice(0, 3),
                              slice(3, 6), slice(6, 9), 9, best, is_tri)
            t_best, u_best, v_best, i_best = _mt_update(
                org, d, rows, rows_i, slice(12, 15), slice(15, 18),
                slice(18, 21), 21, best, is_tri)

            nxt_tri = jnp.where(rows[:, 10] > 0.5, lret, ptr + 8)
            nxt = jnp.where(is_node, nxt_node, nxt_tri)
            nxt = jnp.where(ptr == done, done, nxt)
            lret = jnp.where(is_node & any_hit & (e_sel >= node_end8),
                             exit_sel, lret)
            return nxt, lret, t_best, u_best, v_best, i_best

        state, _ = lax.while_loop(cond, body_k, (state, jnp.int32(0)))
        return state

    # chunk and caps for the BVH8 walk; not yet tuned on the GPU
    return _chunked_walk_driver(init_state, walk_pass, key_fn,
                                table_default, done, default_caps=(24, 0),
                                default_chunk=1024)


def make_mesh_traverser_bvh4(table_np, node_end, stride, root_lo, root_hi):
    """intersect(...) over the BVH4 re-entry walk table (layout and
    phase-encoded pointer semantics: build_walk_table4). Each step gathers
    ONE 32-col row resolving 4 slab tests (node row) or 2 Moller-Trumbore
    tests (tri-pair row); subtree exits re-enter the parent at the next
    child phase, re-culling the remaining children with the shrunken
    t_best."""
    table_default = jnp.asarray(table_np)
    rows_total = table_np.shape[0]
    done = 4 * (rows_total - 1)  # phase-encoded absorbing pointer
    node_end4 = 4 * node_end
    key_fn = _coherence_key_fn(root_lo, root_hi)

    def init_state(d, t_max0, active):
        n = d.shape[0]
        oct_ = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
                + (d[:, 2] < 0)).astype(jnp.int32)
        ptr0 = jnp.where(active, oct_ * (4 * stride), done)
        return (ptr0, jnp.full((n,), done, jnp.int32),
                jnp.minimum(t_max0, BIG), jnp.zeros((n,)), jnp.zeros((n,)),
                jnp.zeros((n,), jnp.int32))

    def walk_pass(table_j, org, d, state, cap):
        inv_d = 1.0 / d

        def cond(sk):
            state, k = sk
            live = jnp.any(state[0] != done)
            return (live & (k < cap)) if cap else live

        def body_k(sk):
            state, k = sk
            return body(state), k + 1

        def body(state):
            ptr, lret, t_best, u_best, v_best, i_best = state
            row_idx = ptr >> 2
            phase = ptr & 3
            rows = table_j[row_idx]  # (n, 32): the one gather per step
            rows_i = lax.bitcast_convert_type(rows, jnp.int32)
            is_node = ptr < node_end4

            # node interpretation: 4 slab tests (NaN pad never hits),
            # masked to child slots >= the re-entry phase
            boxes = rows[:, 0:24].reshape(-1, 4, 6)
            t0 = (boxes[:, :, 0:3] - org[:, None, :]) * inv_d[:, None, :]
            t1 = (boxes[:, :, 3:6] - org[:, None, :]) * inv_d[:, None, :]
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            bh = jnp.maximum(tn, 0.0) <= jnp.minimum(tf, t_best[:, None])
            bh = bh & (jnp.arange(4, dtype=jnp.int32)[None, :]
                       >= phase[:, None])
            any_hit = jnp.any(bh, axis=1) & is_node
            sel = jnp.argmax(bh, axis=1)  # first hit child (near order)
            enters = rows_i[:, 24:28]
            e_sel = jnp.take_along_axis(enters, sel[:, None], 1)[:, 0]
            skp = rows_i[:, 28]
            nxt_node = jnp.where(any_hit, e_sel, skp)
            # child-i exit: re-enter this row at phase i+1 (last: exit)
            exit_sel = jnp.where(sel == rows_i[:, 29] - 1, skp,
                                 (ptr & ~3) + sel + 1)

            # tri-pair interpretation: tri0 then tri1 vs updated t_best
            is_tri = ~is_node
            best = (t_best, u_best, v_best, i_best)
            best = _mt_update(org, d, rows, rows_i, slice(0, 3),
                              slice(3, 6), slice(6, 9), 9, best, is_tri)
            t_best, u_best, v_best, i_best = _mt_update(
                org, d, rows, rows_i, slice(12, 15), slice(15, 18),
                slice(18, 21), 21, best, is_tri)

            nxt_tri = jnp.where(rows[:, 10] > 0.5, lret, ptr + 4)
            nxt = jnp.where(is_node, nxt_node, nxt_tri)
            nxt = jnp.where(ptr == done, done, nxt)
            lret = jnp.where(is_node & any_hit & (e_sel >= node_end4),
                             exit_sel, lret)
            return nxt, lret, t_best, u_best, v_best, i_best

        state, _ = lax.while_loop(cond, body_k, (state, jnp.int32(0)))
        return state

    return _chunked_walk_driver(init_state, walk_pass, key_fn,
                                table_default, done, default_caps=(32, 0))


def make_mesh_traverser_octant(table_np, node_end, m_nodes, root_lo,
                               root_hi):
    """intersect(org, d, t_max0, active) -> (t, u, v, idx, hit) via the
    unified-table octant-ordered walk (see build_walk_table).

    Design notes (vs the reference's recursive descent,
    shape_tree.ml:198-220):
      - each iteration is ONE row gather + ~60 vector ops on all lanes;
        per-lane divergence costs nothing beyond max-lane iterations
        within a coherence-sorted chunk;
      - near-child-first ordering comes from starting each lane at its
        direction octant's root row — zero per-step overhead, no stack;
        t_best shrinks sooner, so far subtrees get culled by the slab
        test instead of walked.
    """
    table_default = jnp.asarray(table_np)
    rows_total = table_np.shape[0]
    done = rows_total - 1
    key_fn = _coherence_key_fn(root_lo, root_hi)

    def init_state(d, t_max0, active):
        n = d.shape[0]
        oct_ = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
                + (d[:, 2] < 0)).astype(jnp.int32)
        ptr0 = jnp.where(active, oct_ * m_nodes, done)
        return (ptr0, jnp.full((n,), done, jnp.int32),
                jnp.minimum(t_max0, BIG), jnp.zeros((n,)), jnp.zeros((n,)),
                jnp.zeros((n,), jnp.int32))

    def walk_pass(table_j, org, d, state, cap):
        """Advance every lane by at most `cap` walk steps (cap=0: run to
        completion). state = (ptr, lret, t_best, u_best, v_best, i_best);
        a finished lane has ptr == done and is inert."""
        inv_d = 1.0 / d

        def cond(sk):
            state, k = sk
            live = jnp.any(state[0] != done)
            return (live & (k < cap)) if cap else live

        def body_k(sk):
            state, k = sk
            return body(state), k + 1

        def body(state):
            ptr, lret, t_best, u_best, v_best, i_best = state
            rows = table_j[ptr]  # (n, 16): the one gather per step
            rows_i = lax.bitcast_convert_type(rows, jnp.int32)
            is_node = ptr < node_end

            # node interpretation: slab test (bbox.ml:40-56)
            lo = rows[:, 0:3]
            hi = rows[:, 3:6]
            t0 = (lo - org) * inv_d
            t1 = (hi - org) * inv_d
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            box_hit = (jnp.maximum(tn, 0.0) <= jnp.minimum(tf, t_best)) \
                & is_node
            enter = rows_i[:, 6]
            skp = rows_i[:, 7]
            is_leaf = enter >= node_end

            # triangle interpretation (Moller-Trumbore, triangle.ml:74-98)
            t_best, u_best, v_best, i_best = _mt_update(
                org, d, rows, rows_i, slice(0, 3), slice(3, 6), slice(6, 9),
                9, (t_best, u_best, v_best, i_best), ~is_node)

            nxt_tri = jnp.where(rows[:, 10] > 0.5, lret, ptr + 1)
            nxt = jnp.where(is_node,
                            jnp.where(box_hit, enter, skp), nxt_tri)
            nxt = jnp.where(ptr == done, done, nxt)
            lret = jnp.where(box_hit & is_leaf, skp, lret)
            return nxt, lret, t_best, u_best, v_best, i_best

        state, _ = lax.while_loop(cond, body_k, (state, jnp.int32(0)))
        return state

    # Chunked + capped multi-pass driver notes (shared with the BVH4 walk):
    #   table: pass the mesh's walk table as a TRACED jit argument to
    #   avoid embedding it as an HLO constant, which multiplies XLA
    #   compile time.
    #   chunk: each chunk's while_loop runs as long as its worst lane, so
    #   chunks of coherence-sorted lanes keep the worst close to the mean;
    #   full-width walks lose that.
    #   caps: each capped pass bounds every chunk's step count, then lanes
    #   RESORT by (finished, current ptr); the final 0 (uncapped) pass
    #   guarantees completion. Bit-exact vs the single-pass walk: per-lane
    #   state updates are independent of chunk grouping.
    return _chunked_walk_driver(init_state, walk_pass, key_fn,
                                table_default, done)


class MeshBVH:
    """Host-side container: a triangle mesh with its flattened BVH and a
    uniform material row (the ganesha mesh pattern, ganesha/bin/main.ml:88-119).

    Vertices must already be in camera space. mat_row is the 12-column
    material layout shared with Scene (scene.TRI_MAT)."""

    def __init__(self, vertices, faces, mat_row, length_cutoff=8,
                 num_bins=32, walk="octant"):
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        assert faces.shape[1] == 3, "expected triangular faces"
        a = vertices[faces[:, 0]]
        b = vertices[faces[:, 1]]
        c = vertices[faces[:, 2]]
        lo = np.minimum(np.minimum(a, b), c)
        hi = np.maximum(np.maximum(a, b), c)
        nodes_lo, nodes_hi, meta, order, depth, axes = build_bvh(
            lo, hi, length_cutoff=length_cutoff, num_bins=num_bins,
            want_axes=True)
        self.depth = depth
        self.n_tris = len(faces)
        self.meta_np = meta
        self.nodes_lo = nodes_lo
        self.nodes_hi = nodes_hi
        self.max_leaf = int(meta[:, 1].max()) if len(meta) else 0
        a, b, c = a[order], b[order], c[order]
        e1 = b - a
        e2 = c - a
        # host numpy: the host-side consumers (material sniffing, tests)
        # read these without a device round-trip; device copies
        # are created once in device_consts()
        self.mat_row = np.asarray(mat_row, np.float32)
        self.bbox_lo = nodes_lo[0].copy()
        self.bbox_hi = nodes_hi[0].copy()
        self.tri_a = np.ascontiguousarray(a)
        self.tri_e1 = np.ascontiguousarray(e1)
        self.tri_e2 = np.ascontiguousarray(e2)
        self._device_tris = None
        self._table_j = None
        self._table_np = None
        self._intersect = None
        self._walk_args = None
        if walk == "bvh8":
            try:
                table, node_end, stride = build_walk_table8(
                    nodes_lo, nodes_hi, meta, axes, a, e1, e2)
            except ValueError:  # >24-bit entries: fall back to BVH4
                walk = "bvh4"
            else:
                self.node_end, self.stride = node_end, stride
                self._table_np = table
                self._walk_args = ("bvh8", node_end, stride,
                                   nodes_lo[0], nodes_hi[0])
                walk = "done"
        if walk == "bvh4":
            table, node_end, stride = build_walk_table4(
                nodes_lo, nodes_hi, meta, axes, a, e1, e2)
            self.node_end, self.stride = node_end, stride
            self._table_np = table
            self._walk_args = ("bvh4", node_end, stride,
                               nodes_lo[0], nodes_hi[0])
        elif walk == "octant":
            # unified-table ordered walk (one gather per step)
            table, node_end, m = build_walk_table(nodes_lo, nodes_hi, meta,
                                                  axes, a, e1, e2)
            self.node_end, self.m_nodes = node_end, m
            self._table_np = table
            self._walk_args = ("octant", node_end, m,
                               nodes_lo[0], nodes_hi[0])
        elif walk != "done":  # "skiplink": round-1 fixed-DFS A/B oracle
            self._intersect = make_mesh_traverser(
                nodes_lo, nodes_hi, meta, a, e1, e2, self.max_leaf)

    def _ensure_device(self):
        """Upload the walk table and build the traverser, once, on first
        use. Deferred out of the constructor so scene builds that never
        render (-stop-after-bvh; the reference's build-time print,
        ganesha/bin/main.ml:188-198) never touch the device."""
        if self._intersect is not None or self._walk_args is None:
            return
        kind, p1, p2, root_lo, root_hi = self._walk_args
        self._table_j = jnp.asarray(self._table_np)
        # pass the device array: jnp.asarray inside the traverser is then
        # a no-op, so the table exists on device exactly once
        maker = {"bvh8": make_mesh_traverser_bvh8,
                 "bvh4": make_mesh_traverser_bvh4,
                 "octant": make_mesh_traverser_octant}[kind]
        self._intersect = maker(self._table_j, p1, p2, root_lo, root_hi)

    @property
    def table_j(self):
        """The device walk table (uploaded on first access; None for the
        skiplink oracle walk, which closes over its arrays instead)."""
        self._ensure_device()
        return self._table_j

    @property
    def intersect(self):
        self._ensure_device()
        return self._intersect

    def device_consts(self):
        """The mesh's large device arrays as a pytree, for threading through
        jit boundaries as ARGUMENTS. Closed-over device arrays are embedded
        in the HLO as constants and XLA compile time explodes on them;
        passing the same arrays as jit arguments avoids that entirely."""
        self._ensure_device()
        if self._device_tris is None:
            # tri_pack9: (9, T) plane-major [a|e1|e2] — a per-lane winner
            # gather pulls all 9 attribute values with ONE index array
            # instead of nine narrow (L,) gathers.
            pack9 = np.concatenate([self.tri_a.T, self.tri_e1.T,
                                    self.tri_e2.T]).astype(np.float32)
            self._device_tris = dict(tri_a=jnp.asarray(self.tri_a),
                                     tri_e1=jnp.asarray(self.tri_e1),
                                     tri_e2=jnp.asarray(self.tri_e2),
                                     tri_pack9=jnp.asarray(pack9),
                                     mat_row=jnp.asarray(self.mat_row))
        consts = dict(self._device_tris)
        if self.table_j is not None:
            consts["table"] = self.table_j
        return consts

    def leaf_histogram(self):
        return leaf_histogram(self.meta_np)


def make_mesh_traverser(nodes_lo, nodes_hi, meta, tri_a, tri_e1, tri_e2,
                        max_leaf: int):
    """Build intersect(org, d, t_max0) -> (t (N,), u, v, idx (N,), hit) over
    the flattened BVH. All arrays are device-resident; per-lane node pointer
    walk with gathers."""
    n_nodes = nodes_lo.shape[0]
    # HOST numpy closures (fast numpy-constant lowering; device-array
    # constants need a device->host copy — see ops/lds.Sampler).
    # This skiplink walk is the A/B oracle path, so embedded constants are
    # acceptable; the production octant walk threads its table as a jit arg.
    nodes_lo = np.asarray(nodes_lo)
    nodes_hi = np.asarray(nodes_hi)
    meta_j = np.asarray(meta)
    tri_a = np.asarray(tri_a)
    tri_e1 = np.asarray(tri_e1)
    tri_e2 = np.asarray(tri_e2)
    eps = np.float32(1e-6)

    # mesh bounds for the coherence key's origin quantization
    root_lo = np.asarray(nodes_lo[0], np.float32)
    root_inv_ext = np.asarray(
        1.0 / np.maximum(nodes_hi[0] - nodes_lo[0], 1e-9), np.float32)

    def _coherence_key(org, d, active):
        """Sort key grouping rays that will walk similar subtrees: direction
        octant (3b) + quantized direction Morton (15b) + origin-cell Morton
        (12b). Chunk cost is its own worst lane, so coherent chunks make
        worst ~= mean (same load-balance idea as the PPM gather sort);
        inactive lanes sort to one tail chunk that exits immediately."""
        from .photon_chunks import morton3
        oct_ = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
                + (d[:, 2] < 0)).astype(jnp.int32)
        dn = d * jax.lax.rsqrt(jnp.maximum(jnp.sum(d * d, 1, keepdims=True),
                                           1e-30))
        q = jnp.clip(((dn + 1.0) * 15.5), 0, 31).astype(jnp.int32)
        dm = morton3(q[:, 0], q[:, 1], q[:, 2])  # 15 bits
        oq = jnp.clip((org - root_lo) * root_inv_ext * 15.0, 0,
                      15).astype(jnp.int32)
        om = morton3(oq[:, 0], oq[:, 1], oq[:, 2])  # 12 bits
        key = (oct_ << 27) | (dm << 12) | om
        return jnp.where(active, key, jnp.int32(2 ** 30))

    def intersect(org, d, t_max0=None, active=None, chunk=512, table=None):
        """Chunked lockstep walk with a per-lane leaf cursor: each while
        iteration
        (`table` is accepted for interface parity with the octant walk and
        ignored: this A/B-oracle path keeps its arrays as closures.)
        either advances the node pointer (box test) or tests ONE leaf
        triangle (k = cursor, -1 = not in a leaf). A single iteration costs
        one node fetch + one triangle fetch for every lane — the global
        while condition means all lanes pay max-lane iterations, so keeping
        the per-iteration cost flat beats a nested leaf loop by ~max_leaf x.
        """
        n = org.shape[0]
        if t_max0 is None:
            t_max0 = jnp.full((n,), BIG)
        if active is None:
            active = jnp.ones((n,), bool)
        # chunking bounds each while_loop's iteration count by its own worst
        # lane instead of the global worst lane; inactive (dead) lanes start
        # finished, so post-bounce-0 wavefronts with few survivors are cheap.
        # Non-divisible n is padded with inactive lanes (never silently
        # unchunked — a round-1 bug: one global worst lane taxed everything).
        if chunk and n > chunk:
            perm = jnp.argsort(_coherence_key(org, d, active))
            inv_perm = jnp.argsort(perm)
            org, d = org[perm], d[perm]
            t_max0, active = t_max0[perm], active[perm]
            pad = (-n) % chunk
            if pad:
                zpad = jnp.zeros((pad, 3), org.dtype)
                org = jnp.concatenate([org, zpad])
                d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])
                t_max0 = jnp.concatenate([t_max0, jnp.zeros((pad,),
                                                            t_max0.dtype)])
                active = jnp.concatenate([active, jnp.zeros((pad,), bool)])
            np_tot = n + pad

            def one(args):
                o, dd, tm, act = args
                return intersect(o, dd, tm, act, chunk=None)
            outs = lax.map(one, (org.reshape(-1, chunk, 3),
                                 d.reshape(-1, chunk, 3),
                                 t_max0.reshape(-1, chunk),
                                 active.reshape(-1, chunk)))
            return tuple(o.reshape(np_tot, *o.shape[2:])[:n][inv_perm]
                         for o in outs)
        inv_d = 1.0 / d
        # convert the host-numpy closures on-trace (numpy can't be indexed
        # by tracers); they lower via the fast numpy-constant path
        nodes_lo_g, nodes_hi_g = jnp.asarray(nodes_lo), jnp.asarray(nodes_hi)
        meta_g = jnp.asarray(meta_j)
        tri_a_g = jnp.asarray(tri_a)
        tri_e1_g, tri_e2_g = jnp.asarray(tri_e1), jnp.asarray(tri_e2)

        def cond(state):
            node = state[0]
            return jnp.any(node < n_nodes)

        def body(state):
            node, k, t_best, u_best, v_best, i_best = state
            nc = jnp.minimum(node, n_nodes - 1)
            mt = meta_g[nc]
            first, count, skip = mt[:, 0], mt[:, 1], mt[:, 2]
            in_leaf = k >= 0

            # --- node step (k < 0): slab test (bbox.ml:40-56) ---
            lo = nodes_lo_g[nc]
            hi = nodes_hi_g[nc]
            t0 = (lo - org) * inv_d
            t1 = (hi - org) * inv_d
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            box_hit = (jnp.maximum(tn, 0.0) <= jnp.minimum(tf, t_best)) \
                & (node < n_nodes)
            is_leaf = count > 0

            # --- leaf step (k >= 0): test triangle first+k ---
            j = jnp.clip(first + jnp.maximum(k, 0), 0, tri_a.shape[0] - 1)
            a = tri_a_g[j]
            e1 = tri_e1_g[j]
            e2 = tri_e2_g[j]
            pvec = jnp.cross(d, e2)
            det = jnp.sum(e1 * pvec, axis=-1)
            det_inv = 1.0 / det
            tvec = org - a
            uu = det_inv * jnp.sum(tvec * pvec, axis=-1)
            qvec = jnp.cross(tvec, e1)
            vv = det_inv * jnp.sum(d * qvec, axis=-1)
            tt = det_inv * jnp.sum(e2 * qvec, axis=-1)
            ok = (in_leaf & (jnp.abs(det) >= eps) & (uu >= 0.0)
                  & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                  & (tt >= 0.0) & (tt <= jnp.minimum(t_best, t_max0)))
            t_best = jnp.where(ok, tt, t_best)
            u_best = jnp.where(ok, uu, u_best)
            v_best = jnp.where(ok, vv, v_best)
            i_best = jnp.where(ok, j, i_best)

            # --- state transition ---
            k1 = k + 1
            leaf_done = in_leaf & (k1 >= count)
            # entering: hit leaf -> k=0 stay; hit inner -> descend; miss -> skip
            enter_node = jnp.where(box_hit & ~is_leaf, node + 1, skip)
            new_node = jnp.where(in_leaf,
                                 jnp.where(leaf_done, skip, node), enter_node)
            new_k = jnp.where(in_leaf,
                              jnp.where(leaf_done, -1, k1),
                              jnp.where(box_hit & is_leaf, 0, -1))
            # a lane that hits a leaf stays on it (node unchanged, k=0)
            new_node = jnp.where(~in_leaf & box_hit & is_leaf, node, new_node)
            new_node = jnp.where(state[0] >= n_nodes, n_nodes, new_node)
            return new_node, new_k, t_best, u_best, v_best, i_best

        n0 = jnp.where(active, 0, n_nodes).astype(jnp.int32)
        init = (n0, jnp.full((n,), -1, jnp.int32), jnp.minimum(t_max0, BIG),
                jnp.zeros((n,)), jnp.zeros((n,)), jnp.zeros((n,), jnp.int32))
        _, _, t, u, v, idx = lax.while_loop(cond, body, init)
        hit = t < jnp.minimum(t_max0, BIG)
        return t, u, v, idx, hit

    return intersect
