// Binned-SAH BVH builder — native runtime tier.
//
// Same construction semantics as ops/bvh.py (and the reference's
// shape_tree.ml:82-195: binned SAH over 3 axes, cost = costT +
// (Al*Nl + Ar*Nr)*costI/Atotal, leaf when count <= 4 or SAH-stop with
// count <= length_cutoff), emitted in depth-first order with skip links.
// Exposed to Python via ctypes (see native/__init__.py). The reference's
// native tier is its Rust AVX kernel + OCaml runtime; here the hot compute
// path is Pallas/XLA and the host-side build/IO tier is C++.
//
// Build: g++ -O3 -march=native -shared -fPIC bvh_build.cc -o libbvh.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <atomic>
#include <future>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Node {
  float lo[3], hi[3];
  int32_t first, count, skip;  // count>0 => leaf
  int32_t axis;                // split axis for inner nodes, -1 for leaves
};

// The hot data rides in position-ordered parallel arrays permuted
// alongside the primitive indices (idx / wbox / binid below): every
// binning pass streams memory sequentially instead of gathering through
// idx, centroids are recomputed on the fly (0.5f*(lo+hi) — the same f32
// expression the old precomputed tables held, so split decisions are
// bit-identical), one fused pass bins all 3 axes at once, the partition
// predicate is a cached bin-id lookup, and child node boxes come from
// the parent's bin prefix/suffix unions (min/max is exact, so the union
// of the same primitive set in any association is the same bits) instead
// of a fresh prim_union pass. Output is byte-identical to the previous
// 6-pass builder (the partition replicates libstdc++'s bidirectional
// std::partition loop); the rewrite is ~3x on the 449k-tri ganesha.
struct Builder {
  // shared position-ordered working arrays (base pointers; parallel
  // tasks operate on disjoint position ranges)
  int32_t* idx;      // position -> primitive id
  float* wbox;       // (n,6) interleaved prim lo|hi, permuted with idx
  uint16_t* binid;   // (n,3) per-axis bin of the latest binning pass
  int length_cutoff, num_bins;
  float cost_i, cost_t;
  std::vector<Node> nodes;
  std::vector<int32_t> order;   // leaf-contiguous primitive permutation
  int max_depth = 0;
  // per-node scratch, hoisted out of the recursion
  std::vector<int> bc;      // (3, nb) bin counts
  std::vector<float> bbox;  // (3, nb, 6) bin boxes (lo|hi)

  static inline float area(const float lo[3], const float hi[3]) {
    float dx = std::max(hi[0] - lo[0], 0.f);
    float dy = std::max(hi[1] - lo[1], 0.f);
    float dz = std::max(hi[2] - lo[2], 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }

  void prim_union(int64_t pos, int count, float lo[3], float hi[3]) const {
    for (int a = 0; a < 3; ++a) {
      lo[a] = 1e30f;
      hi[a] = -1e30f;
    }
    const float* w = wbox + 6 * pos;
    for (int k = 0; k < count; ++k, w += 6) {
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], w[a]);
        hi[a] = std::max(hi[a], w[3 + a]);
      }
    }
  }

  inline void swap_payload(int64_t i, int64_t j) {
    std::swap(idx[i], idx[j]);
    for (int q = 0; q < 6; ++q) std::swap(wbox[6 * i + q], wbox[6 * j + q]);
    for (int q = 0; q < 3; ++q)
      std::swap(binid[3 * i + q], binid[3 * j + q]);
  }

  // Split decision + in-place partition, shared by the serial recursion
  // and the parallel skeleton phase (so both produce identical trees).
  // Returns true for a leaf; otherwise *mid/*axis describe the split and
  // the position range is partitioned. When the split came from a clean
  // SAH partition, lbox/rbox receive the children's primitive-union
  // boxes (lo|hi, 6 floats) and *child_boxes is set, saving the
  // children's prim_union pass.
  bool decide_split(int64_t pos, int count, const float node_lo[3],
                    const float node_hi[3], int* mid, int* axis_out,
                    float lbox[6], float rbox[6], bool* child_boxes) {
    *child_boxes = false;
    bool make_leaf = count <= 4;
    int best_axis = -1, best_bin = -1;
    float best_cost = 1e30f;
    const int nb = num_bins;
    if (!make_leaf) {
      float total_area = std::max(area(node_lo, node_hi), 1e-30f);
      // pass A: centroid bounds, all 3 axes fused
      float cmin[3] = {1e30f, 1e30f, 1e30f};
      float cmax[3] = {-1e30f, -1e30f, -1e30f};
      {
        const float* w = wbox + 6 * pos;
        for (int k = 0; k < count; ++k, w += 6) {
          for (int a = 0; a < 3; ++a) {
            float c = 0.5f * (w[a] + w[3 + a]);
            cmin[a] = std::min(cmin[a], c);
            cmax[a] = std::max(cmax[a], c);
          }
        }
      }
      bool axis_ok[3];
      float scale[3];
      bool any_ok = false;
      for (int a = 0; a < 3; ++a) {
        axis_ok[a] = !(cmax[a] - cmin[a] < 1e-12f);
        scale[a] = axis_ok[a] ? nb / (cmax[a] - cmin[a]) : 0.f;
        any_ok |= axis_ok[a];
      }
      if (any_ok) {
        // pass B: bin all valid axes at once; cache the bin ids
        bc.assign(3 * nb, 0);
        bbox.resize(3 * nb * 6);
        for (int i = 0; i < 3 * nb; ++i) {
          float* b = &bbox[6 * i];
          b[0] = b[1] = b[2] = 1e30f;
          b[3] = b[4] = b[5] = -1e30f;
        }
        const float* w = wbox + 6 * pos;
        uint16_t* bi = binid + 3 * pos;
        for (int k = 0; k < count; ++k, w += 6, bi += 3) {
          for (int a = 0; a < 3; ++a) {
            if (!axis_ok[a]) continue;
            float c = 0.5f * (w[a] + w[3 + a]);
            int b = std::min(nb - 1,
                             std::max(0, (int)((c - cmin[a]) * scale[a])));
            bi[a] = (uint16_t)b;
            bc[a * nb + b]++;
            float* bb = &bbox[6 * (a * nb + b)];
            for (int q = 0; q < 3; ++q) {
              bb[q] = std::min(bb[q], w[q]);
              bb[3 + q] = std::max(bb[3 + q], w[3 + q]);
            }
          }
        }
        // per-axis prefix/suffix area scans + cost eval, original order
        for (int axis = 0; axis < 3; ++axis) {
          if (!axis_ok[axis]) continue;
          const float* ab = &bbox[6 * (axis * nb)];
          const int* ac = &bc[axis * nb];
          // suffix areas first (small nb: scratch on the stack)
          float suf_area[256];
          float s_lo[3] = {1e30f, 1e30f, 1e30f};
          float s_hi[3] = {-1e30f, -1e30f, -1e30f};
          for (int b = nb - 1; b >= 0; --b) {
            for (int q = 0; q < 3; ++q) {
              s_lo[q] = std::min(s_lo[q], ab[6 * b + q]);
              s_hi[q] = std::max(s_hi[q], ab[6 * b + 3 + q]);
            }
            suf_area[b] = area(s_lo, s_hi);
          }
          float acc_lo[3] = {1e30f, 1e30f, 1e30f};
          float acc_hi[3] = {-1e30f, -1e30f, -1e30f};
          int acc_n = 0;
          for (int b = 0; b < nb - 1; ++b) {
            for (int q = 0; q < 3; ++q) {
              acc_lo[q] = std::min(acc_lo[q], ab[6 * b + q]);
              acc_hi[q] = std::max(acc_hi[q], ab[6 * b + 3 + q]);
            }
            acc_n += ac[b];
            if (acc_n == 0 || acc_n == count) continue;
            float al = area(acc_lo, acc_hi);
            float cost = cost_t +
                         (al * acc_n + suf_area[b + 1] * (count - acc_n)) *
                             cost_i / total_area;
            if (cost < best_cost) {
              best_cost = cost;
              best_axis = axis;
              best_bin = b;
            }
          }
        }
      }
      float leaf_cost = count * cost_i;
      bool sah_stop = best_axis >= 0 && best_cost >= leaf_cost;
      if (count <= length_cutoff && (best_axis < 0 || sah_stop))
        make_leaf = true;
    }
    if (make_leaf) return true;

    if (best_axis < 0) {
      *mid = count / 2;  // degenerate centroids: median split
      // ordered traversal wants SOME axis: use the longest bbox extent
      float ext[3] = {node_hi[0] - node_lo[0], node_hi[1] - node_lo[1],
                      node_hi[2] - node_lo[2]};
      *axis_out = (int)(std::max_element(ext, ext + 3) - ext);
    } else {
      // libstdc++ bidirectional std::partition, replicated so the
      // permutation matches the previous idx-only builder exactly
      const int ba = best_axis;
      const uint16_t bb = (uint16_t)best_bin;
      int64_t f = pos, l = pos + count;
      for (;;) {
        for (;;) {
          if (f == l) goto part_done;
          if (binid[3 * f + ba] <= bb)
            ++f;
          else
            break;
        }
        --l;
        for (;;) {
          if (f == l) goto part_done;
          if (binid[3 * l + ba] > bb)
            --l;
          else
            break;
        }
        swap_payload(f, l);
        ++f;
      }
    part_done:
      *mid = (int)(f - pos);
      if (*mid == 0 || *mid == count) {
        *mid = count / 2;
      } else {
        // children's prim unions from the bin scans (exact)
        const float* ab = &bbox[6 * (best_axis * nb)];
        for (int q = 0; q < 6; ++q) {
          lbox[q] = (q < 3) ? 1e30f : -1e30f;
          rbox[q] = (q < 3) ? 1e30f : -1e30f;
        }
        for (int b = 0; b < nb; ++b) {
          float* dst = (b <= best_bin) ? lbox : rbox;
          for (int q = 0; q < 3; ++q) {
            dst[q] = std::min(dst[q], ab[6 * b + q]);
            dst[3 + q] = std::max(dst[3 + q], ab[6 * b + 3 + q]);
          }
        }
        *child_boxes = true;
      }
      *axis_out = best_axis;
    }
    return false;
  }

  int rec(int64_t pos, int count, int depth, const float* box = nullptr) {
    max_depth = std::max(max_depth, depth);
    int me = (int)nodes.size();
    nodes.emplace_back();
    if (box) {
      std::memcpy(nodes[me].lo, box, 12);
      std::memcpy(nodes[me].hi, box + 3, 12);
    } else {
      prim_union(pos, count, nodes[me].lo, nodes[me].hi);
    }
    nodes[me].first = 0;
    nodes[me].count = 0;
    nodes[me].skip = 0;
    nodes[me].axis = -1;

    int mid, axis;
    float lbox[6], rbox[6];
    bool cb = false;
    if (decide_split(pos, count, nodes[me].lo, nodes[me].hi, &mid, &axis,
                     lbox, rbox, &cb)) {
      nodes[me].first = (int32_t)order.size();
      nodes[me].count = count;
      for (int k = 0; k < count; ++k) order.push_back(idx[pos + k]);
      nodes[me].skip = me + 1;
      return me;
    }
    nodes[me].axis = axis;
    rec(pos, mid, depth + 1, cb ? lbox : nullptr);
    rec(pos + mid, count - mid, depth + 1, cb ? rbox : nullptr);
    nodes[me].skip = (int32_t)nodes.size();
    return me;
  }
};

// Parallel SAH build: a serial skeleton phase splits the top of the tree
// until subtrees are small enough to farm out, worker threads build each
// subtree with the SAME decide_split/rec code into local Builders, and a
// serial stitch re-emits everything in global DFS order with index
// fixups — the output is byte-identical to the serial build (the split
// logic, partition, and DFS order are unchanged; only who executes them
// differs).
struct ParBuilder {
  struct Skel {
    float lo[3], hi[3];
    int axis;
    int left = -1, right = -1;  // skeleton children
    int task = -1;              // >= 0: subtree built by a worker
  };
  struct Task {
    int64_t pos;
    int count, depth;
    float box[6];
    bool has_box;
  };

  Builder top;  // split decisions + scratch for the skeleton phase
  std::vector<Skel> skel;
  std::vector<Task> tasks;
  std::vector<Builder> task_builders;
  int task_threshold = 0;

  int build_skeleton(int64_t pos, int count, int depth,
                     const float* box = nullptr) {
    int me = (int)skel.size();
    skel.emplace_back();
    if (box) {
      std::memcpy(skel[me].lo, box, 12);
      std::memcpy(skel[me].hi, box + 3, 12);
    } else {
      top.prim_union(pos, count, skel[me].lo, skel[me].hi);
    }
    skel[me].axis = -1;
    int mid, axis;
    float lbox[6], rbox[6];
    bool cb = false;
    if (count <= task_threshold || depth >= 8
        || top.decide_split(pos, count, skel[me].lo, skel[me].hi, &mid,
                            &axis, lbox, rbox, &cb)) {
      skel[me].task = (int)tasks.size();
      Task t;
      t.pos = pos;
      t.count = count;
      t.depth = depth;
      t.has_box = true;
      std::memcpy(t.box, skel[me].lo, 12);
      std::memcpy(t.box + 3, skel[me].hi, 12);
      tasks.push_back(t);
      return me;
    }
    skel[me].axis = axis;
    int l = build_skeleton(pos, mid, depth + 1, cb ? lbox : nullptr);
    skel[me].left = l;
    int r = build_skeleton(pos + mid, count - mid, depth + 1,
                           cb ? rbox : nullptr);
    skel[me].right = r;
    return me;
  }

  // stitch one skeleton node into the output Builder-style arrays
  void emit(int si, std::vector<Node>& nodes, std::vector<int32_t>& order,
            int* max_depth, int depth) {
    const Skel& s = skel[si];
    if (s.task >= 0) {
      const Builder& b = task_builders[s.task];
      int node_base = (int)nodes.size();
      int order_base = (int)order.size();
      for (const Node& n : b.nodes) {
        nodes.push_back(n);
        Node& m = nodes.back();
        if (m.count > 0) {
          m.first += order_base;
          m.skip = (int32_t)(node_base + (&n - b.nodes.data()) + 1);
        } else {
          m.skip += node_base;
        }
      }
      order.insert(order.end(), b.order.begin(), b.order.end());
      // task builders were launched at their absolute depth, so their
      // max_depth is already absolute
      *max_depth = std::max(*max_depth, b.max_depth);
      return;
    }
    int me = (int)nodes.size();
    nodes.emplace_back();
    std::memcpy(nodes[me].lo, s.lo, 12);
    std::memcpy(nodes[me].hi, s.hi, 12);
    nodes[me].first = 0;
    nodes[me].count = 0;
    nodes[me].axis = s.axis;
    *max_depth = std::max(*max_depth, depth);
    emit(s.left, nodes, order, max_depth, depth + 1);
    emit(s.right, nodes, order, max_depth, depth + 1);
    nodes[me].skip = (int32_t)nodes.size();
  }

  // idx/wbox/binid are the shared position-ordered arrays (owned by the
  // caller); tasks touch disjoint position ranges, so the threads never
  // contend.
  void run(int32_t* idx, float* wbox, uint16_t* binid, int n,
           int length_cutoff, int num_bins, float cost_i, float cost_t,
           std::vector<Node>& nodes, std::vector<int32_t>& order,
           int* max_depth) {
    top.idx = idx;
    top.wbox = wbox;
    top.binid = binid;
    top.length_cutoff = length_cutoff;
    top.num_bins = num_bins;
    top.cost_i = cost_i;
    top.cost_t = cost_t;
    unsigned hw = std::max(2u, std::thread::hardware_concurrency());
    task_threshold = std::max(4096, n / (int)(4 * hw));
    build_skeleton(0, n, 1);

    task_builders.resize(tasks.size());
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        size_t t = next.fetch_add(1);
        if (t >= tasks.size()) return;
        Builder& b = task_builders[t];
        b.idx = idx;
        b.wbox = wbox;
        b.binid = binid;
        b.length_cutoff = length_cutoff;
        b.num_bins = num_bins;
        b.cost_i = cost_i;
        b.cost_t = cost_t;
        b.nodes.reserve(2 * tasks[t].count);
        b.order.reserve(tasks[t].count);
        b.rec(tasks[t].pos, tasks[t].count, tasks[t].depth,
              tasks[t].has_box ? tasks[t].box : nullptr);
      }
    };
    std::vector<std::thread> ts;
    unsigned nt = std::min<size_t>(hw, tasks.size());
    for (unsigned i = 0; i < nt; ++i) ts.emplace_back(worker);
    for (auto& th : ts) th.join();

    nodes.reserve(2 * n);
    order.reserve(n);
    *max_depth = 0;
    emit(0, nodes, order, max_depth, 1);
  }
};

}  // namespace

namespace {

// Depth-first re-flattening of the canonical tree for one direction
// octant: children are emitted near-first by the sign of the ray
// direction along each node's split axis (the reference's ordered
// descent, shape_tree.ml:198-220, recast as 8 precomputed layouts so the
// lockstep device walk stays a branch-free skip-link chase). Canonical child
// derivation: left = i+1, right = meta[left].skip (index just past
// left's subtree).
struct OctFlattener {
  const int32_t* meta;  // (m,3) canonical [first, count, skip]
  const int32_t* axes;  // (m,) split axis, -1 for leaves
  int oct;              // (dx<0)<<2 | (dy<0)<<1 | (dz<0)
  int32_t* perm;        // new index -> canonical index
  int32_t* enter;       // leaf: -(first+1); inner: near-child new index
  int32_t* skip;        // new index just past the subtree
  int cnt = 0;

  int rec(int ci) {
    int ni = cnt++;
    perm[ni] = ci;
    if (meta[3 * ci + 1] > 0) {  // leaf
      enter[ni] = -(meta[3 * ci] + 1);
    } else {
      int l = ci + 1;
      int r = meta[3 * l + 2];
      bool neg = (oct >> (2 - axes[ci])) & 1;  // d[axis]<0 => right first
      int near_c = neg ? r : l;
      int far_c = neg ? l : r;
      enter[ni] = rec(near_c);
      rec(far_c);
    }
    skip[ni] = cnt;
    return ni;
  }
};

}  // namespace

namespace {

// Shared driver: serial Builder for small inputs, ParBuilder above the
// threshold (outputs are byte-identical; threads only pay off at scale).
int build_common(const float* prim_lo, const float* prim_hi, int n,
                 int length_cutoff, int num_bins, float cost_i,
                 float cost_t, float* nodes_lo, float* nodes_hi,
                 int32_t* meta, int32_t* order_out, int32_t* depth_out,
                 int32_t* axes_out) {
  // scratch limits (binid is uint16, suffix-area scratch is 256 wide);
  // the callers pass 32
  num_bins = std::min(num_bins, 256);
  std::vector<Node> nodes;
  std::vector<int32_t> order;
  int max_depth = 0;
  // position-ordered working copies, permuted in place by the partitions
  std::vector<int32_t> idx(n);
  std::vector<float> wbox((size_t)n * 6);
  std::vector<uint16_t> binid((size_t)n * 3);
  for (int i = 0; i < n; ++i) {
    idx[i] = i;
    std::memcpy(&wbox[6 * (size_t)i], prim_lo + 3 * i, 12);
    std::memcpy(&wbox[6 * (size_t)i + 3], prim_hi + 3 * i, 12);
  }
  if (n >= 65536 && std::thread::hardware_concurrency() > 1) {
    ParBuilder pb;
    pb.run(idx.data(), wbox.data(), binid.data(), n, length_cutoff,
           num_bins, cost_i, cost_t, nodes, order, &max_depth);
  } else {
    Builder b;
    b.idx = idx.data();
    b.wbox = wbox.data();
    b.binid = binid.data();
    b.length_cutoff = length_cutoff;
    b.num_bins = num_bins;
    b.cost_i = cost_i;
    b.cost_t = cost_t;
    b.nodes.reserve(2 * n);
    b.order.reserve(n);
    b.rec(0, n, 1);
    nodes.swap(b.nodes);
    order.swap(b.order);
    max_depth = b.max_depth;
  }
  int m = (int)nodes.size();
  for (int i = 0; i < m; ++i) {
    std::memcpy(nodes_lo + 3 * i, nodes[i].lo, 12);
    std::memcpy(nodes_hi + 3 * i, nodes[i].hi, 12);
    meta[3 * i] = nodes[i].first;
    meta[3 * i + 1] = nodes[i].count;
    meta[3 * i + 2] = nodes[i].skip;
    if (axes_out) axes_out[i] = nodes[i].axis;
  }
  std::memcpy(order_out, order.data(), 4 * order.size());
  depth_out[0] = max_depth;
  return m;
}

}  // namespace

extern "C" {

// Returns the node count; fills the output arrays (caller allocates
// nodes_* with capacity 2n, order with n). depth_out[0] = tree depth.
int bvh_build(const float* prim_lo, const float* prim_hi, int n,
              int length_cutoff, int num_bins, float cost_i, float cost_t,
              float* nodes_lo, float* nodes_hi, int32_t* meta,
              int32_t* order_out, int32_t* depth_out) {
  return build_common(prim_lo, prim_hi, n, length_cutoff, num_bins, cost_i,
                      cost_t, nodes_lo, nodes_hi, meta, order_out,
                      depth_out, nullptr);
}

// bvh_build plus per-node split axes (needed for ordered traversal
// layouts). axes_out capacity 2n; -1 for leaves.
int bvh_build2(const float* prim_lo, const float* prim_hi, int n,
               int length_cutoff, int num_bins, float cost_i, float cost_t,
               float* nodes_lo, float* nodes_hi, int32_t* meta,
               int32_t* order_out, int32_t* depth_out, int32_t* axes_out) {
  return build_common(prim_lo, prim_hi, n, length_cutoff, num_bins, cost_i,
                      cost_t, nodes_lo, nodes_hi, meta, order_out,
                      depth_out, axes_out);
}

// ---- BVH4 re-entry walk table (ops/bvh.py build_walk_table4: layout &
// phase-encoded pointer semantics) ----
//
// Collapses the binary tree two levels at a time: each inner node's row
// tests up to 4 grandchild/child-leaf boxes at once; triangles pack two
// per 32-col row. Pointers are row*4+phase; a child's subtree exit
// re-enters its parent at phase i+1. The 8 octant regions are
// structurally identical (only child order differs), so `stride` is
// computed once and the fills run on 8 threads.

namespace {

// Post-order sizing over a collapsed (4- or 8-wide) view of the binary
// tree — ONE definition shared by the BVH4/BVH8 rows & fill passes so the
// sizing rule cannot desynchronize between them (rows vs fill disagreement
// corrupts the table layout). size[ci] = row count of ci's collapsed
// subtree; optionally also the total tri-pair row count and each leaf's
// first pair row (canonical leaf order — matches the python builders).
typedef int (*CollapseFn)(const int32_t*, int, int*);

static void collapse_sizes(const int32_t* meta, int m, CollapseFn collapse,
                           std::vector<int64_t>& size, int64_t* n_pairs_out,
                           std::vector<int64_t>* pair_first) {
  size.assign(m, 0);
  std::vector<std::pair<int32_t, bool>> stack;
  stack.push_back({0, false});
  int64_t n_pairs = 0;
  while (!stack.empty()) {
    auto [ci, ready] = stack.back();
    stack.pop_back();
    if (meta[3 * ci + 1] > 0) {
      size[ci] = 0;  // leaves are entered directly, no guard row
      n_pairs += (meta[3 * ci + 1] + 1) / 2;
      continue;
    }
    int els[8];
    int k = collapse(meta, ci, els);
    if (ready) {
      int64_t s = 1;
      for (int i = 0; i < k; ++i) s += size[els[i]];
      size[ci] = s;
    } else {
      stack.push_back({ci, true});
      for (int i = 0; i < k; ++i) stack.push_back({els[i], false});
    }
  }
  if (n_pairs_out) *n_pairs_out = n_pairs;
  if (pair_first) {
    pair_first->assign(m, 0);
    int64_t pr = 0;  // leaves in canonical order (matches python builder)
    for (int ci = 0; ci < m; ++ci)
      if (meta[3 * ci + 1] > 0) {
        (*pair_first)[ci] = pr;
        pr += (meta[3 * ci + 1] + 1) / 2;
      }
  }
}

// tri-pair rows: identical layout in the BVH4 and BVH8 tables
// (zero-filled: det==0 pad tris never hit; row[10] = last-pair flag)
static void fill_tri_pair_rows(float* table, int64_t node_end, int64_t rows,
                               const int32_t* meta, int m, const float* tri_a,
                               const float* tri_e1, const float* tri_e2,
                               const std::vector<int64_t>& pair_first) {
  std::memset(table + 32 * node_end, 0, (size_t)(rows - node_end) * 128);
  for (int ci = 0; ci < m; ++ci) {
    int n = meta[3 * ci + 1];
    if (n <= 0) continue;
    int fidx = meta[3 * ci];
    int64_t p0 = node_end + pair_first[ci];
    for (int j = 0; j < n; j += 2) {
      float* row = table + 32 * (p0 + j / 2);
      int32_t* rowi = (int32_t*)row;
      std::memcpy(row, tri_a + 3 * (fidx + j), 12);
      std::memcpy(row + 3, tri_e1 + 3 * (fidx + j), 12);
      std::memcpy(row + 6, tri_e2 + 3 * (fidx + j), 12);
      rowi[9] = fidx + j;
      if (j + 1 < n) {
        std::memcpy(row + 12, tri_a + 3 * (fidx + j + 1), 12);
        std::memcpy(row + 15, tri_e1 + 3 * (fidx + j + 1), 12);
        std::memcpy(row + 18, tri_e2 + 3 * (fidx + j + 1), 12);
        rowi[21] = fidx + j + 1;
      }
      row[10] = (j + 2 >= n) ? 1.0f : 0.0f;
    }
  }
}

// elements of the collapsed node: binary child if leaf, else its children
static inline int collapse4(const int32_t* meta, int ci, int els[4]) {
  int l = ci + 1;
  int r = meta[3 * l + 2];
  int k = 0;
  for (int y : {l, r}) {
    if (meta[3 * y + 1] > 0) {
      els[k++] = y;
    } else {
      int yl = y + 1;
      els[k++] = yl;
      els[k++] = meta[3 * yl + 2];
    }
  }
  return k;
}

struct Oct4Filler {
  const float* nlo;
  const float* nhi;
  const int32_t* meta;
  const int32_t* axes;
  const int64_t* size4;
  const int64_t* pair_first;
  int64_t node_end, done;
  const float* tri_a;
  const float* tri_e1;
  const float* tri_e2;
  float* table;  // (rows, 32)

  void near_order(int ci, int o, int els[4], int* k_out) const {
    int l = ci + 1;
    int r = meta[3 * l + 2];
    bool negp = (o >> (2 - axes[ci])) & 1;
    int outer[2] = {negp ? r : l, negp ? l : r};
    int k = 0;
    for (int oi = 0; oi < 2; ++oi) {
      int y = outer[oi];
      if (meta[3 * y + 1] > 0) {
        els[k++] = y;
      } else {
        int yl = y + 1;
        int yr = meta[3 * yl + 2];
        bool neg = (o >> (2 - axes[y])) & 1;
        els[k++] = neg ? yr : yl;
        els[k++] = neg ? yl : yr;
      }
    }
    *k_out = k;
  }

  void fill(int o, int64_t stride) const {
    const float kNaN = std::numeric_limits<float>::quiet_NaN();
    int64_t base = (int64_t)o * stride;
    int64_t done_ptr = 4 * done;
    struct Item {
      int32_t ci;
      int64_t row, exit_ptr;  // exit_ptr is phase-encoded
    };
    std::vector<Item> stack;
    stack.push_back({0, base, done_ptr});
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      float* row = table + 32 * it.row;
      int32_t* rowi = (int32_t*)row;
      for (int c = 0; c < 32; ++c) row[c] = kNaN;
      if (meta[3 * it.ci + 1] > 0) {  // leaf root: degenerate 1-child row
        std::memcpy(row, nlo + 3 * it.ci, 12);
        std::memcpy(row + 3, nhi + 3 * it.ci, 12);
        rowi[24] = (int32_t)(4 * (node_end + pair_first[it.ci]));
        rowi[25] = rowi[26] = rowi[27] = (int32_t)done_ptr;
        rowi[28] = (int32_t)it.exit_ptr;
        rowi[29] = 1;
        continue;
      }
      int els[4], k;
      near_order(it.ci, o, els, &k);
      int64_t entry = it.row + 1;
      rowi[24] = rowi[25] = rowi[26] = rowi[27] = (int32_t)done_ptr;
      for (int i = 0; i < k; ++i) {
        int e = els[i];
        std::memcpy(row + 6 * i, nlo + 3 * e, 12);
        std::memcpy(row + 6 * i + 3, nhi + 3 * e, 12);
        int64_t ex = (i + 1 < k) ? 4 * it.row + i + 1 : it.exit_ptr;
        if (meta[3 * e + 1] > 0) {  // leaf child: direct tri entry
          rowi[24 + i] = (int32_t)(4 * (node_end + pair_first[e]));
        } else {
          rowi[24 + i] = (int32_t)(4 * entry);
          stack.push_back({e, entry, ex});
          entry += size4[e];
        }
      }
      rowi[28] = (int32_t)it.exit_ptr;
      rowi[29] = k;
    }
  }
};

}  // namespace

// Phase 1: sizes. Returns total rows; stride_out[0] = per-octant row count.
int64_t bvh4_table_rows(const int32_t* meta, int m, int32_t* stride_out) {
  if (m == 0) {
    stride_out[0] = 1;
    return 8 + 1;
  }
  std::vector<int64_t> size4;
  int64_t n_pairs = 0;
  collapse_sizes(meta, m, collapse4, size4, &n_pairs, nullptr);
  int64_t stride = std::max<int64_t>(size4[0], 1);
  stride_out[0] = (int32_t)stride;
  return 8 * stride + n_pairs + 1;
}

// Phase 2: fill the caller-allocated (rows, 32) table.
void bvh4_table_fill(const float* nodes_lo, const float* nodes_hi,
                     const int32_t* meta, const int32_t* axes, int m,
                     const float* tri_a, const float* tri_e1,
                     const float* tri_e2, int t_cnt, float* table,
                     int64_t rows, int32_t stride) {
  int64_t node_end = 8 * (int64_t)stride;
  int64_t done = rows - 1;
  if (m == 0) {
    std::memset(table, 0, (size_t)rows * 128);
    return;
  }
  // recompute size4 + pair_first (cheap vs the fill)
  std::vector<int64_t> size4, pair_first;
  collapse_sizes(meta, m, collapse4, size4, nullptr, &pair_first);

  Oct4Filler f{nodes_lo, nodes_hi, meta,   axes,   size4.data(),
               pair_first.data(), node_end, done,  tri_a,
               tri_e1,  tri_e2,  table};
  std::vector<std::thread> ts;
  for (int o = 0; o < 8; ++o)
    ts.emplace_back([&f, o, stride]() { f.fill(o, stride); });
  for (auto& t : ts) t.join();

  fill_tri_pair_rows(table, node_end, rows, meta, m, tri_a, tri_e1, tri_e2,
                     pair_first);
}

// ---- BVH8 re-entry walk table (ops/bvh.py build_walk_table8: layout &
// phase-encoded pointer semantics) ----
//
// Same re-entry idea as BVH4 but collapsing THREE binary levels per row.
// Child boxes are quantized CWBVH-style relative to the row's own frame
// (absolute bf16 was tried first and inflated deep-leaf boxes by ~2x —
// bf16 granularity is absolute, ~0.008 at coordinate 2.0, while deep
// boxes are ~0.03 wide): cols 0-2 = frame origin (node bbox lo, f32),
// cols 3-5 = per-axis scale (extent/254, f32), cols 6-17 = 48 uint8
// quantized bounds (byte 2*(3i+a) = qlo of child i axis a rounded down,
// byte 2*(3i+a)+1 = qhi rounded up; decode b = origin + q*scale; an
// extra +-1 quantum guards f32/fma decode rounding so loose boxes can
// only cost extra entries, never miss). Empty slots: qlo=255, qhi=0
// (inverted => slab test can never pass). 8 entry pointers packed 24-bit
// in cols 18-23 (bit0 = last-child flag; entry ptrs are 8-aligned so 3
// low bits are free), exit ptr in col 24. Pointer: ptr = row*8 + phase.

namespace {

// up-to-8 elements of the 3-level collapse (octant-independent)
static inline int collapse8(const int32_t* meta, int ci, int els[8]) {
  int k = 0;
  // expand y two more levels below the child boundary
  auto expand = [&](auto&& self, int y, int depth) -> void {
    if (depth == 0 || meta[3 * y + 1] > 0) {
      els[k++] = y;
      return;
    }
    int yl = y + 1;
    self(self, yl, depth - 1);
    self(self, meta[3 * yl + 2], depth - 1);
  };
  int l = ci + 1;
  int r = meta[3 * l + 2];
  expand(expand, l, 2);
  expand(expand, r, 2);
  return k;
}

struct Oct8Filler {
  const float* nlo;
  const float* nhi;
  const int32_t* meta;
  const int32_t* axes;
  const int64_t* size8;
  const int64_t* pair_first;
  int64_t node_end, done;
  const float* tri_a;
  const float* tri_e1;
  const float* tri_e2;
  float* table;  // (rows, 32)

  // octant-ordered expansion: near-first by each expanded node's axis
  void near_order(int ci, int o, int els[8], int* k_out) const {
    int k = 0;
    auto expand = [&](auto&& self, int y, int depth) -> void {
      if (depth == 0 || meta[3 * y + 1] > 0) {
        els[k++] = y;
        return;
      }
      int yl = y + 1;
      int yr = meta[3 * yl + 2];
      bool neg = (o >> (2 - axes[y])) & 1;
      self(self, neg ? yr : yl, depth - 1);
      self(self, neg ? yl : yr, depth - 1);
    };
    int l = ci + 1;
    int r = meta[3 * l + 2];
    bool negp = (o >> (2 - axes[ci])) & 1;
    expand(expand, negp ? r : l, 2);
    expand(expand, negp ? l : r, 2);
    *k_out = k;
  }

  void fill(int o, int64_t stride) const {
    int64_t base = (int64_t)o * stride;
    int64_t done_ptr = 8 * done;
    struct Item {
      int32_t ci;
      int64_t row, exit_ptr;
    };
    std::vector<Item> stack;
    stack.push_back({0, base, done_ptr});
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      float* row = table + 32 * it.row;
      int32_t* rowi = (int32_t*)row;
      for (int c = 0; c < 32; ++c) row[c] = 0.0f;
      uint32_t ev[8];
      for (int i = 0; i < 8; ++i) ev[i] = (uint32_t)done_ptr & 0xFFFFFFu;
      int els[8], k = 0;
      if (meta[3 * it.ci + 1] > 0) {  // leaf root: degenerate 1-child row
        els[0] = it.ci;
        k = 1;
        ev[0] = (uint32_t)(8 * (node_end + pair_first[it.ci])) | 1u;
      } else {
        near_order(it.ci, o, els, &k);
        int64_t entry = it.row + 1;
        for (int i = 0; i < k; ++i) {
          int e = els[i];
          uint32_t last = (i == k - 1) ? 1u : 0u;
          int64_t ex = (i + 1 < k) ? 8 * it.row + i + 1 : it.exit_ptr;
          if (meta[3 * e + 1] > 0) {  // leaf child: direct tri entry
            ev[i] = (uint32_t)(8 * (node_end + pair_first[e])) | last;
          } else {
            ev[i] = (uint32_t)(8 * entry) | last;
            stack.push_back({e, entry, ex});
            entry += size8[e];
          }
        }
      }
      // quantization frame: this node's bbox
      const float* flo = nlo + 3 * it.ci;
      const float* fhi = nhi + 3 * it.ci;
      float scale[3];
      for (int a = 0; a < 3; ++a) {
        row[a] = flo[a];
        scale[a] = std::max(fhi[a] - flo[a], 1e-30f) / 254.0f;
        row[3 + a] = scale[a];
      }
      uint8_t qb[48];
      for (int i = 0; i < 8; ++i)
        for (int a = 0; a < 3; ++a) {
          qb[2 * (3 * i + a)] = 255;  // empty slot: inverted box
          qb[2 * (3 * i + a) + 1] = 0;
        }
      for (int i = 0; i < k; ++i) {
        const float* clo = nlo + 3 * els[i];
        const float* chi = nhi + 3 * els[i];
        for (int a = 0; a < 3; ++a) {
          int ql = (int)std::floor((clo[a] - row[a]) / scale[a]) - 1;
          int qh = (int)std::ceil((chi[a] - row[a]) / scale[a]) + 1;
          ql = std::min(std::max(ql, 0), 255);
          qh = std::min(std::max(qh, 0), 255);
          // verify conservativeness under f32 decode; the +-1 above
          // already guards fma/rounding, this catches clamping edges
          while (ql > 0 && row[a] + (float)ql * scale[a] > clo[a]) --ql;
          while (qh < 255 && row[a] + (float)qh * scale[a] < chi[a]) ++qh;
          qb[2 * (3 * i + a)] = (uint8_t)ql;
          qb[2 * (3 * i + a) + 1] = (uint8_t)qh;
        }
      }
      for (int c = 0; c < 12; ++c)
        rowi[6 + c] = (int32_t)((uint32_t)qb[4 * c] |
                                ((uint32_t)qb[4 * c + 1] << 8) |
                                ((uint32_t)qb[4 * c + 2] << 16) |
                                ((uint32_t)qb[4 * c + 3] << 24));
      // pack 8x24-bit entries into cols 18..23
      uint8_t bytes[24];
      for (int i = 0; i < 8; ++i) {
        bytes[3 * i] = ev[i] & 0xFF;
        bytes[3 * i + 1] = (ev[i] >> 8) & 0xFF;
        bytes[3 * i + 2] = (ev[i] >> 16) & 0xFF;
      }
      for (int c = 0; c < 6; ++c)
        rowi[18 + c] = (int32_t)((uint32_t)bytes[4 * c] |
                                 ((uint32_t)bytes[4 * c + 1] << 8) |
                                 ((uint32_t)bytes[4 * c + 2] << 16) |
                                 ((uint32_t)bytes[4 * c + 3] << 24));
      rowi[24] = (int32_t)it.exit_ptr;
      // arity masks unused slots out of the slab test (the min/max slab
      // test is symmetric in lo/hi, so an inverted box would NOT miss)
      rowi[25] = k;
    }
  }
};

}  // namespace

// Phase 1: sizes. Returns total rows; stride_out[0] = per-octant rows.
int64_t bvh8_table_rows(const int32_t* meta, int m, int32_t* stride_out) {
  if (m == 0) {
    stride_out[0] = 1;
    return 8 + 1;
  }
  std::vector<int64_t> size8;
  int64_t n_pairs = 0;
  collapse_sizes(meta, m, collapse8, size8, &n_pairs, nullptr);
  int64_t stride = std::max<int64_t>(size8[0], 1);
  stride_out[0] = (int32_t)stride;
  return 8 * stride + n_pairs + 1;
}

// Phase 2: fill the caller-allocated (rows, 32) table.
void bvh8_table_fill(const float* nodes_lo, const float* nodes_hi,
                     const int32_t* meta, const int32_t* axes, int m,
                     const float* tri_a, const float* tri_e1,
                     const float* tri_e2, int t_cnt, float* table,
                     int64_t rows, int32_t stride) {
  int64_t node_end = 8 * (int64_t)stride;
  int64_t done = rows - 1;
  if (m == 0) {
    std::memset(table, 0, (size_t)rows * 128);
    return;
  }
  std::vector<int64_t> size8, pair_first;
  collapse_sizes(meta, m, collapse8, size8, nullptr, &pair_first);

  Oct8Filler f{nodes_lo, nodes_hi, meta,   axes,   size8.data(),
               pair_first.data(), node_end, done,  tri_a,
               tri_e1,  tri_e2,  table};
  std::vector<std::thread> ts;
  for (int o = 0; o < 8; ++o)
    ts.emplace_back([&f, o, stride]() { f.fill(o, stride); });
  for (auto& t : ts) t.join();

  fill_tri_pair_rows(table, node_end, rows, meta, m, tri_a, tri_e1, tri_e2,
                     pair_first);
}

// Emit the 8 octant-ordered flattenings of a canonical skip-link tree.
// Outputs are stacked per octant: perm/enter/skip each have 8*m entries
// (octant o occupies [o*m, (o+1)*m)).
void bvh_flatten_octants(const int32_t* meta, const int32_t* axes, int m,
                         int32_t* perm, int32_t* enter, int32_t* skip) {
  for (int o = 0; o < 8; ++o) {
    OctFlattener f;
    f.meta = meta;
    f.axes = axes;
    f.oct = o;
    f.perm = perm + (size_t)o * m;
    f.enter = enter + (size_t)o * m;
    f.skip = skip + (size_t)o * m;
    if (m > 0) f.rec(0);
  }
}
}
