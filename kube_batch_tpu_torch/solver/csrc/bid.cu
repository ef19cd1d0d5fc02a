// Hopper (sm_90a) kernels for the solver's fused bid pass, with a plain C
// interface for ctypes (kube_batch_tpu_torch/solver/bid_kernels.py).
//
// kbt_bid_dense replaces the Pallas TPU kernel `pallas_bid` / `_bid_kernel`
// (kube_batch_tpu/solver/pallas_kernels.py:147, pallas_call at :204);
// kbt_bid_sparse replaces `pallas_bid_sparse` / `_sparse_bid_kernel`
// (pallas_kernels.py:323, pallas_call at :373). Each computes, per task row:
// the epsilon fit `fit - idle < eps` over all R dimensions, AND the static
// feasibility, node pod-count capacity and task gate, LeastRequested +
// Balanced on (cpu, mem) plus the optional static score, the integer bid key
// (quantized score << 10 | hash10(task, node)), and the row's best key with
// the lowest column (dense) or lowest global node id (sparse) among ties.
// Outputs: bid i32[T] (N when nothing is feasible) and any_feas u8[T].
//
// What bounds them on an H100. The dense pass at the main path's shapes
// (51,200 x 5,120, nearly every cell scored) is bound by instruction rate,
// not by its 262 MB mask read (0.08 ms at 3.35 TB/s): a scored cell is ~55
// instructions (fit test, four quotients by the node's capacity, score, key,
// hash, running max), most of them float32. The sparse pass reads a [T, K]
// slab of node ids and static scores (8 bytes a candidate) and scores K
// cells a row; at K = 64 its instruction time and its slab time are of one
// order.
//
// Design:
// - Persistent blocks: as many as fit on the card at once (one per SM when
//   the node table is large), from the SM count and shared memory limit
//   read once per device at its first launch. Block b takes the groups of
//   rows b, b + grid, b + 2*grid, ...: interleaving spreads the runs of
//   cheap rows (assigned tasks) over all blocks.
// - A node table in shared memory, struct of arrays, built in the block's
//   prologue with plain coalesced loads, four nodes a thread at a time (it
//   is derived data, not a copy, so cp.async or TMA would buy nothing; on
//   the main path it is built once per block). Per node: {s_c, s_m, rcp_c,
//   rcp_m} (s = cap if cap > 0 else 0; rcp its correctly rounded reciprocal,
//   or 0), (idle_c, idle_m) with idle_c a NaN where cap_ok is false (so the
//   fit test fails), the node's share of the hash, and planes of idle for
//   dimensions 2..R-1: 28 bytes a node at R=2, 152 KB at 5,120 nodes. Node i
//   of a tile sits at slot i + i/16, so lanes 16 columns apart hit distinct
//   banks. A table larger than the shared memory is cut into tiles of
//   columns; each row carries its running (key, column) across tiles,
//   which ascend, so a strict > keeps the first column (argmax's rule).
// - Dense rows: a warp per row, 16 rows a block. A lane loads 16
//   feasibility bytes per 16-byte load (and 4 static scores per float4),
//   skips all-zero groups, and scores the 16 cells without a branch (the
//   mask is applied by a select), so their chains interleave; at R=2 the 16
//   cells are unrolled, at larger R four at a time. Rows whose start is not
//   16-byte aligned, N % 16 columns, and rows off the reciprocal route go
//   column by column. Each lane visits its columns in ascending order; a
//   shuffle reduction takes (max key, lowest column).
// - Sparse rows: a half-warp per row, 4 candidates per lane per int4/float4
//   load (at K = 64 one load a lane), a scalar tail when K is not a
//   multiple of 4 or the row is not aligned. Ties keep the lowest global
//   node id (Pallas's rule); ids outside [0, N) are padding and never
//   dereferenced. When the table for all N nodes does not fit, the kernel
//   gathers idle and cap from device memory per candidate instead (chosen
//   by size in kbt_bid_sparse).
//
// Numerics: the keys must be bit-equal to the plain PyTorch version and to
// the JAX package as XLA compiles it. Built with --fmad=false, so no product
// is contracted implicitly; the two products XLA does contract into fused
// multiply-adds (10 - diff*10 and lr_w*lr + br_w*br) are explicit
// __fmaf_rn; XLA's `score / 0.02` is `score * 50` (the float32 reciprocal
// rounds to exactly 50); the key's rounding is half to even like jnp.round
// (see make_key); the hash runs in uint32.
//
// The reciprocal route. The four quotients a / s of a scored cell are
// computed without MUFU division as q0 = a*rcp, r = fma(-s, q0, a),
// q = fma(r, rcp, q0), with rcp = RN(1/s) from the table: one Markstein
// correction. q is RN(a / s), i.e. __fdiv_rn(a, s), wherever nothing
// overflows or underflows. Powers of two scale out, so take significands
// a, s in [1, 2). Where a >= s, q0 is within (a/4 + 1/2) ulp of a / s, a
// faithful rounding, and Markstein's theorem (rcp = RN(1/s), q0 faithful)
// gives RN(a / s). Where a < s, q0 can be up to 2 ulp off; then q differs
// from a / s by at most |q0 - a/s| * 2^-23, about 2^-22 ulp, and can
// round the other way only if a / s lies that close to a rounding
// midpoint. Those pairs are few (2^25 a - s m = c, |c| <= 8, for a
// midpoint m), and tests/test_torch_bid.py checks every one of them
// (23 M pairs; q0 alone is wrong on half of them).
// The route is taken for a row and a tile when every value that enters a
// quotient is 0 or has a magnitude in [2^-40, 2^60]: the task's req_c,
// req_m; the tile's idle_c, idle_m and s_c, s_m (of nodes that pass
// cap_ok). Then every nonzero numerator lies in [2^-63, 2^65] (a multiple of
// 2^-63 below 2^61, times 10 at most), every quotient in [2^-123, 2^105] and
// every nonzero remainder r above 2^-110: all normal floats. Where s = 0
// (cap <= 0) the table's rcp is 0 too and the route gives q = 0, which is
// what the cap > 0 test gives (LeastRequested 0, fraction 1). Rows or tiles
// outside the range use __fdiv_rn, as does the sparse gather path.
// tests/test_torch_bid.py holds the route against IEEE division on random
// and adversarial pairs in the range, and chip_smoke.py holds the kernels
// against their plain versions on the card, extreme capacities included.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

// The node table (dynamic shared memory, sized at launch).
extern __shared__ __align__(16) unsigned char kbt_smem[];

namespace {

// Threads per block. Dense: a warp per row, 16 rows a pass (the 16-cell
// unroll wants ~110 registers). Sparse: a half-warp per row; at R=2 the
// kernel fits 64 registers, so 1,024 threads (64 rows a pass).
constexpr int kDenseThreads = 512;
__host__ __device__ constexpr int sparse_threads(int kR) {
  return kR == 2 ? 1024 : 512;
}
constexpr int kBuildBatch = 4;  // table nodes a thread loads at once
constexpr int kMaxR = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kMaxPriority = 10.0f;
constexpr float kInvQuantum = 50.0f;
constexpr float kKeyHalf = 524288.0f;    // 2^19: keys hold 20 score bits
// Adding 1.5 * 2^23 to a float of magnitude <= 2^22 rounds it to an
// integer, half to even, held in the low bits of the sum's representation
// (0x4B400000 + the integer).
constexpr float kRoundMagic = 12582912.0f;
constexpr uint32_t kRoundMagicBits = 0x4B400000u;
constexpr uint32_t kRowHashMul = 2654435761u;
constexpr uint32_t kNodeHashMul = 0x9E3779B9u;
constexpr uint32_t kMixMul = 2246822519u;
// Magnitudes for which the reciprocal route equals __fdiv_rn (see above).
constexpr float kRouteLo = 0x1p-40f;
constexpr float kRouteHi = 0x1p60f;
// Table bytes per node: float4 {s, rcp} + float2 idle (cpu, mem) + u32 hash,
// plus one float per further dimension.
constexpr int kNodeBytes2 = 16 + 8 + 4;

__host__ __device__ __forceinline__ int table_bytes(int tile, int R) {
  return (tile + tile / 16) * (kNodeBytes2 + 4 * (R - 2));
}

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// The hash's first two steps, x = (t * 2654435761) ^ (n * 0x9E3779B9) and
// x ^= x >> 13, are linear over bits, so each factor's share is taken once:
// th = mix(t * 2654435761) per row, nh = mix(n * 0x9E3779B9) per node.
__device__ __forceinline__ uint32_t mix13(uint32_t v) {
  return v ^ (v >> 13);
}

__device__ __forceinline__ bool in_route(float x) {
  const float m = fabsf(x);
  return x == 0.0f || (m >= kRouteLo && m <= kRouteHi);
}

// The node table (views into dynamic shared memory), P slots.
struct Table {
  float4* div;    // s_c, s_m, rcp_c, rcp_m
  float2* cm;     // idle_c (NaN where cap_ok is false), idle_m
  uint32_t* nh;   // mix13(n * kNodeHashMul)
  float* x;       // idle[d] for d >= 2, plane (d - 2) at x + (d - 2) * P
  int P;
};

__device__ __forceinline__ Table table_view(int tile) {
  Table tb;
  tb.P = tile + tile / 16;
  tb.div = reinterpret_cast<float4*>(kbt_smem);
  tb.cm = reinterpret_cast<float2*>(kbt_smem + 16 * tb.P);
  tb.nh = reinterpret_cast<uint32_t*>(kbt_smem + 24 * tb.P);
  tb.x = reinterpret_cast<float*>(kbt_smem + 28 * tb.P);
  return tb;
}

struct Node {
  float4 div;
  float2 cm;
  uint32_t nh;
  bool route;
};

__device__ __forceinline__ Node make_node(const float* idle, const float* cap,
                                          const uint8_t* cap_ok, int n,
                                          int R) {
  const float* in = idle + static_cast<size_t>(n) * R;
  const float* cn = cap + static_cast<size_t>(n) * R;
  const float ic = in[0], im = in[1], cc = cn[0], cm = cn[1];
  const bool ok = cap_ok[n] != 0;
  Node e;
  e.div.x = cc > 0.0f ? cc : 0.0f;
  e.div.y = cm > 0.0f ? cm : 0.0f;
  e.div.z = cc > 0.0f ? __frcp_rn(cc) : 0.0f;
  e.div.w = cm > 0.0f ? __frcp_rn(cm) : 0.0f;
  e.cm = make_float2(ok ? ic : __int_as_float(0x7fffffff), im);
  e.nh = mix13(static_cast<uint32_t>(n) * kNodeHashMul);
  e.route = !ok || (in_route(e.div.x) && in_route(e.div.y) && in_route(ic) &&
                    in_route(im));
  return e;
}

// Builds the table for nodes [n0, n1); returns, to every thread of the
// block, whether the whole tile may take the reciprocal route.
template <int kR>
__device__ bool build_tile(const Table& tb, int n0, int n1, const float* idle,
                           const float* cap, const uint8_t* cap_ok, int R) {
  const int nd = kR ? kR : R;
  const int step = blockDim.x;
  bool route = true;
  // kBuildBatch nodes per thread at a time, so their loads are in flight
  // together.
  for (int i0 = threadIdx.x; i0 < n1 - n0; i0 += kBuildBatch * step) {
    Node e[kBuildBatch];
#pragma unroll
    for (int u = 0; u < kBuildBatch; ++u) {
      const int i = i0 + u * step;
      if (i < n1 - n0) e[u] = make_node(idle, cap, cap_ok, n0 + i, nd);
    }
#pragma unroll
    for (int u = 0; u < kBuildBatch; ++u) {
      const int i = i0 + u * step;
      if (i >= n1 - n0) continue;
      const int p = slot(i);
      tb.div[p] = e[u].div;
      tb.cm[p] = e[u].cm;
      tb.nh[p] = e[u].nh;
      for (int d = 2; d < nd; ++d) {
        tb.x[(d - 2) * tb.P + p] =
            idle[static_cast<size_t>(n0 + i) * nd + d];
      }
      route = route && e[u].route;
    }
  }
  return __syncthreads_and(route) != 0;
}

// One task row's operands, in registers.
template <int kR>
struct Row {
  static constexpr int kDims = kR ? kR : kMaxR;
  float fit[kDims];
  float eps[kDims];
  float req_c, req_m;
  uint32_t th;  // mix13(task_id * kRowHashMul)
  bool route;
};

template <int kR>
__device__ __forceinline__ void load_row(Row<kR>& tr, const float* fit,
                                         const float* req, const float* eps,
                                         const int32_t* task_ids, int row,
                                         int R) {
  const int nd = kR ? kR : R;
#pragma unroll
  for (int d = 0; d < Row<kR>::kDims; ++d) {
    const bool live = kR || d < nd;
    tr.fit[d] = live ? fit[static_cast<size_t>(row) * nd + d] : 0.0f;
    tr.eps[d] = live ? eps[d] : 1.0f;
  }
  tr.req_c = req[static_cast<size_t>(row) * nd + 0];
  tr.req_m = req[static_cast<size_t>(row) * nd + 1];
  tr.th = mix13(static_cast<uint32_t>(task_ids[row]) * kRowHashMul);
  tr.route = in_route(tr.req_c) && in_route(tr.req_m);
}

// a / s, or 0 where s == 0 (cap <= 0). kRoute: the reciprocal route.
template <bool kRoute>
__device__ __forceinline__ float quot(float a, float s, float rcp) {
  if (kRoute) {
    const float q0 = __fmul_rn(a, rcp);
    const float r = __fmaf_rn(-s, q0, a);
    return __fmaf_rn(r, rcp, q0);
  }
  return s > 0.0f ? __fdiv_rn(a, s) : 0.0f;
}

// LeastRequested + Balanced on (cpu, mem) in the JAX package's order.
template <bool kRoute>
__device__ __forceinline__ float dyn_score(float req_c, float req_m,
                                           float2 idle, float4 dv, float lr_w,
                                           float br_w) {
  const float rem_c = __fsub_rn(idle.x, req_c);
  const float rem_m = __fsub_rn(idle.y, req_m);
  const float lr = __fmul_rn(
      __fadd_rn(
          quot<kRoute>(__fmul_rn(fmaxf(rem_c, 0.0f), kMaxPriority), dv.x,
                       dv.z),
          quot<kRoute>(__fmul_rn(fmaxf(rem_m, 0.0f), kMaxPriority), dv.y,
                       dv.w)),
      0.5f);
  const float frac_c = __fsub_rn(1.0f, quot<kRoute>(rem_c, dv.x, dv.z));
  const float frac_m = __fsub_rn(1.0f, quot<kRoute>(rem_m, dv.y, dv.w));
  const float diff = fabsf(__fsub_rn(frac_c, frac_m));
  const float br = (frac_c >= 1.0f || frac_m >= 1.0f)
                       ? 0.0f
                       : __fmaf_rn(-diff, kMaxPriority, kMaxPriority);
  return __fmaf_rn(br_w, br, __fmul_rn(lr, lr_w));
}

// (clip(rint(score * 50) + 2^19, 0, 2^20 - 1) << 10) | hash10(t, n). The
// clip is taken first, as rint(clip(score * 50, -2^19, 2^19 - 1)) + 2^19:
// the bounds are integers, so the value is the same, a NaN lands on 0 as
// before (fmaxf(NaN, x) is x), and the rounding is then an add, with no
// conversion instructions.
__device__ __forceinline__ int32_t make_key(float score, uint32_t th,
                                            uint32_t nh) {
  const float u = fminf(fmaxf(__fmul_rn(score, kInvQuantum), -kKeyHalf),
                        kKeyHalf - 1.0f);
  const uint32_t q = __float_as_uint(__fadd_rn(u, kRoundMagic)) -
                     (kRoundMagicBits - (1u << 19));
  const uint32_t x = (th ^ nh) * kMixMul;
  return static_cast<int32_t>((q << 10) | ((x >> 8) & 1023u));
}

// The key of one cell, or -1 when the task does not fit the node. `xs`
// points at idle[2] of the node, further dimensions `xstride` apart.
template <int kR, bool kRoute, bool kStatic>
__device__ __forceinline__ int32_t cell_key(const Row<kR>& tr, float2 cm,
                                            float4 dv, uint32_t nh,
                                            const float* xs, int xstride,
                                            int R, float st, float lr_w,
                                            float br_w) {
  bool ok = (__fsub_rn(tr.fit[0], cm.x) < tr.eps[0]) &
            (__fsub_rn(tr.fit[1], cm.y) < tr.eps[1]);
#pragma unroll
  for (int d = 2; d < Row<kR>::kDims; ++d) {
    if (kR || d < R) {
      ok = ok & (__fsub_rn(tr.fit[d], xs[(d - 2) * xstride]) < tr.eps[d]);
    }
  }
  // Computed whether or not the task fits, then selected: no branch, so
  // the cells of a lane's group interleave.
  float score = dyn_score<kRoute>(tr.req_c, tr.req_m, cm, dv, lr_w, br_w);
  if (kStatic) score = __fadd_rn(score, st);
  const int32_t key = make_key(score, tr.th, nh);
  return ok ? key : -1;
}

// Column j (table slot p) of a row; `feasible` is its static mask bit.
template <int kR, bool kRoute, bool kStatic>
__device__ __forceinline__ void dense_cell(const Row<kR>& tr, const Table& tb,
                                           int j, int p, bool feasible, int R,
                                           float st, float lr_w, float br_w,
                                           int32_t& best_key,
                                           int32_t& best_col) {
  int32_t key = cell_key<kR, kRoute, kStatic>(
      tr, tb.cm[p], tb.div[p], tb.nh[p], tb.x + p, tb.P, R, st, lr_w, br_w);
  key = feasible ? key : -1;
  // A lane visits its columns in ascending order: a strict > keeps the
  // lowest.
  if (key > best_key) {
    best_key = key;
    best_col = j;
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Columns c + 4q .. c + 4q + 3 (slots p0 + 4q ..), whose feasibility bytes
// are `w`.
template <int kR, bool kRoute, bool kStatic>
__device__ __forceinline__ void dense_word(const Row<kR>& tr, const Table& tb,
                                           int c, int p0, int q, uint32_t w,
                                           const float* srow, int R,
                                           float lr_w, float br_w,
                                           int32_t& best_key,
                                           int32_t& best_col) {
  const float4 s =
      kStatic ? __ldg(reinterpret_cast<const float4*>(srow + c) + q)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    dense_cell<kR, kRoute, kStatic>(tr, tb, c + 4 * q + b, p0 + 4 * q + b,
                                    ((w >> (8 * b)) & 0xffu) != 0u, R,
                                    lane_of(s, b), lr_w, br_w, best_key,
                                    best_col);
  }
}

// Columns [n0, n1) of one row against the tile in the table.
template <int kR, bool kRoute, bool kStatic>
__device__ __forceinline__ void dense_span(const Row<kR>& tr, const Table& tb,
                                           const uint8_t* frow,
                                           const float* srow, int n0, int n1,
                                           int lane, int R, float lr_w,
                                           float br_w, int32_t& best_key,
                                           int32_t& best_col) {
  // 16-column groups need the row (and its static row) 16-byte aligned at
  // n0 (a multiple of 16); other rows, and the reciprocal route's
  // fallback, go column by column.
  const bool vec = kRoute &&
                   (reinterpret_cast<uintptr_t>(frow + n0) & 15u) == 0 &&
                   (!kStatic ||
                    (reinterpret_cast<uintptr_t>(srow + n0) & 15u) == 0);
  const int groups = vec ? (n1 - n0) >> 4 : 0;
  for (int g = lane; g < groups; g += 32) {
    const int c = n0 + g * 16;
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(frow + c));
    if ((f.x | f.y | f.z | f.w) == 0u) continue;
    const int p0 = slot(g * 16);  // the group's 16 slots are consecutive
    // All 16 cells unrolled at R=2 (independent chains interleave); four
    // at a time otherwise, which keeps the wider row in registers.
    if (kR == 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dense_word<kR, kRoute, kStatic>(tr, tb, c, p0, q, word_of(f, q), srow,
                                        R, lr_w, br_w, best_key, best_col);
      }
    } else {
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        dense_word<kR, kRoute, kStatic>(tr, tb, c, p0, q, word_of(f, q), srow,
                                        R, lr_w, br_w, best_key, best_col);
      }
    }
  }
  for (int j = n0 + groups * 16 + lane; j < n1; j += 32) {
    dense_cell<kR, kRoute, kStatic>(tr, tb, j, slot(j - n0), frow[j] != 0, R,
                                    kStatic ? srow[j] : 0.0f, lr_w, br_w,
                                    best_key, best_col);
  }
}

// (max key, then lowest id) across `kWidth` lanes; the segment's first lane
// writes the row's result.
template <int kWidth>
__device__ __forceinline__ void reduce_and_store(int32_t best_key,
                                                 int32_t best_id, int lane,
                                                 bool store, int row, int N,
                                                 int32_t* bid,
                                                 uint8_t* any_feas) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) {
    const int32_t k2 = __shfl_down_sync(kFullMask, best_key, off, kWidth);
    const int32_t i2 = __shfl_down_sync(kFullMask, best_id, off, kWidth);
    if (k2 > best_key || (k2 == best_key && i2 < best_id)) {
      best_key = k2;
      best_id = i2;
    }
  }
  if (store && (lane & (kWidth - 1)) == 0) {
    const bool has = best_key >= 0;
    bid[row] = has ? best_id : N;
    any_feas[row] = has ? 1 : 0;
  }
}

// kR: 2, or 0 for any R in [2, kMaxR]. `tile`: columns per table tile (a
// multiple of 16).
template <int kR, bool kStatic>
__global__ void __launch_bounds__(kDenseThreads, 1)
bid_dense_kernel(const float* __restrict__ fit, const float* __restrict__ req,
                 const uint8_t* __restrict__ task_ok,
                 const uint8_t* __restrict__ feas,
                 const float* __restrict__ idle, const float* __restrict__ cap,
                 const uint8_t* __restrict__ cap_ok,
                 const float* __restrict__ eps,
                 const float* __restrict__ static_rows,
                 const int32_t* __restrict__ task_ids, int32_t* bid,
                 uint8_t* any_feas, int T, int N, int R, int tile, float lr_w,
                 float br_w) {
  constexpr int kRowsPerBlock = kDenseThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Table tb = table_view(tile);
  const int ntiles = (N + tile - 1) / tile;
  bool tile_route = false;
  if (ntiles == 1) tile_route = build_tile<kR>(tb, 0, N, idle, cap, cap_ok, R);
  for (int base = blockIdx.x * kRowsPerBlock; base < T;
       base += gridDim.x * kRowsPerBlock) {
    const int row = base + warp;
    const bool active = row < T && task_ok[row];
    Row<kR> tr{};
    if (active) load_row<kR>(tr, fit, req, eps, task_ids, row, R);
    const uint8_t* frow = feas + static_cast<size_t>(row) * N;
    const float* srow =
        kStatic ? static_rows + static_cast<size_t>(row) * N : nullptr;
    int32_t best_key = -1;
    int32_t best_col = N;
    for (int t = 0; t < ntiles; ++t) {
      const int n0 = t * tile;
      const int n1 = min(N, n0 + tile);
      if (ntiles > 1) {
        __syncthreads();  // every warp is done with the previous tile
        tile_route = build_tile<kR>(tb, n0, n1, idle, cap, cap_ok, R);
      }
      if (!active) continue;
      if (tile_route && tr.route) {
        dense_span<kR, true, kStatic>(tr, tb, frow, srow, n0, n1, lane, R,
                                      lr_w, br_w, best_key, best_col);
      } else {
        dense_span<kR, false, kStatic>(tr, tb, frow, srow, n0, n1, lane, R,
                                       lr_w, br_w, best_key, best_col);
      }
    }
    reduce_and_store<32>(best_key, best_col, lane, row < T, row, N, bid,
                         any_feas);
  }
}

// One candidate of a sparse row.
template <int kR, bool kTable, bool kRoute>
__device__ __forceinline__ void sparse_cell(
    const Row<kR>& tr, const Table& tb, const float* idle, const float* cap,
    const uint8_t* cap_ok, int32_t j, float st, int N, int R, float lr_w,
    float br_w, int32_t& best_key, int32_t& best_id) {
  if (j < 0 || j >= N) return;  // padding id: never dereferenced
  int32_t key;
  if (kTable) {
    const int p = slot(j);
    key = cell_key<kR, kRoute, true>(tr, tb.cm[p], tb.div[p], tb.nh[p],
                                     tb.x + p, tb.P, R, st, lr_w, br_w);
  } else {
    const int nd = kR ? kR : R;
    const Node e = make_node(idle, cap, cap_ok, j, nd);
    key = cell_key<kR, false, true>(tr, e.cm, e.div, e.nh,
                                    idle + static_cast<size_t>(j) * nd + 2, 1,
                                    R, st, lr_w, br_w);
  }
  if (key > best_key || (key == best_key && j < best_id)) {
    best_key = key;
    best_id = j;
  }
}

template <int kR, bool kTable, bool kRoute>
__device__ __forceinline__ void sparse_row(
    const Row<kR>& tr, const Table& tb, const int32_t* crow,
    const float* srow, const float* idle, const float* cap,
    const uint8_t* cap_ok, int K, int N, int R, int lane16, float lr_w,
    float br_w, int32_t& best_key, int32_t& best_id) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(crow) | reinterpret_cast<uintptr_t>(srow)) &
       15u) == 0;
  const int kv = aligned ? (K & ~3) : 0;  // candidates read 4 at a time
  for (int k = lane16 * 4; k < kv; k += 64) {
    const int4 c = __ldg(reinterpret_cast<const int4*>(crow + k));
    const float4 s = __ldg(reinterpret_cast<const float4*>(srow + k));
    sparse_cell<kR, kTable, kRoute>(tr, tb, idle, cap, cap_ok, c.x, s.x, N, R,
                                    lr_w, br_w, best_key, best_id);
    sparse_cell<kR, kTable, kRoute>(tr, tb, idle, cap, cap_ok, c.y, s.y, N, R,
                                    lr_w, br_w, best_key, best_id);
    sparse_cell<kR, kTable, kRoute>(tr, tb, idle, cap, cap_ok, c.z, s.z, N, R,
                                    lr_w, br_w, best_key, best_id);
    sparse_cell<kR, kTable, kRoute>(tr, tb, idle, cap, cap_ok, c.w, s.w, N, R,
                                    lr_w, br_w, best_key, best_id);
  }
  for (int k = kv + lane16; k < K; k += 16) {
    sparse_cell<kR, kTable, kRoute>(tr, tb, idle, cap, cap_ok, crow[k],
                                    srow[k], N, R, lr_w, br_w, best_key,
                                    best_id);
  }
}

// kTable: the table of all N nodes is in shared memory; otherwise idle/cap
// are gathered from device memory per candidate.
template <int kR, bool kTable>
__global__ void __launch_bounds__(sparse_threads(kR), 1)
bid_sparse_kernel(const float* __restrict__ fit, const float* __restrict__ req,
                  const uint8_t* __restrict__ task_ok,
                  const int32_t* __restrict__ cand,
                  const float* __restrict__ cand_static,
                  const float* __restrict__ idle,
                  const float* __restrict__ cap,
                  const uint8_t* __restrict__ cap_ok,
                  const float* __restrict__ eps,
                  const int32_t* __restrict__ task_ids, int32_t* bid,
                  uint8_t* any_feas, int T, int N, int K, int R, int tile,
                  float lr_w, float br_w) {
  constexpr int kRowsPerBlock = sparse_threads(kR) / 16;
  const int lane16 = threadIdx.x & 15;
  const Table tb = table_view(tile);
  bool table_route = false;
  if (kTable) table_route = build_tile<kR>(tb, 0, N, idle, cap, cap_ok, R);
  for (int base = blockIdx.x * kRowsPerBlock; base < T;
       base += gridDim.x * kRowsPerBlock) {
    const int row = base + (threadIdx.x >> 4);
    const bool active = row < T && task_ok[row];
    int32_t best_key = -1;
    int32_t best_id = N;
    if (active) {
      Row<kR> tr;
      load_row<kR>(tr, fit, req, eps, task_ids, row, R);
      const int32_t* crow = cand + static_cast<size_t>(row) * K;
      const float* srow = cand_static + static_cast<size_t>(row) * K;
      if (kTable && table_route && tr.route) {
        sparse_row<kR, kTable, true>(tr, tb, crow, srow, idle, cap, cap_ok, K,
                                     N, R, lane16, lr_w, br_w, best_key,
                                     best_id);
      } else {
        sparse_row<kR, kTable, false>(tr, tb, crow, srow, idle, cap, cap_ok,
                                      K, N, R, lane16, lr_w, br_w, best_key,
                                      best_id);
      }
    }
    reduce_and_store<16>(best_key, best_id, lane16, row < T, row, N, bid,
                         any_feas);
  }
}

// ---------------------------------------------------------------------------
// Launch set-up: the SM count and the opt-in shared memory limit of each
// device, read at its first launch, and the dynamic shared memory attribute
// of each kernel, set once per device.
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

struct DeviceInfo {
  int dev = 0;
  int sms = 0;
  int smem = 0;  // bytes of shared memory a block may opt into
};

// Per kernel and device: whether the shared memory attribute is set, and
// the occupancy found for the last table size.
struct KernelState {
  bool attr = false;
  int smem = -1;
  int per_sm = 0;
};

std::mutex g_mu;
DeviceInfo g_dev[kMaxDevices];

cudaError_t device_info(DeviceInfo* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mu);
  DeviceInfo& d = g_dev[dev];
  if (d.sms == 0) {
    d.dev = dev;
    err = cudaDeviceGetAttribute(&d.smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) {
      d.sms = 0;
      return err;
    }
  }
  *out = d;
  return cudaSuccess;
}

// Opts the kernel into the device's shared memory limit (once per device)
// and returns the grid for `work` row groups: as many blocks as fit on the
// device at once, at most one per row group.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, KernelState* states,
                    const DeviceInfo& info, int threads, int smem, int work,
                    int* grid) {
  std::lock_guard<std::mutex> lock(g_mu);
  KernelState& st = states[info.dev];
  if (!st.attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, info.smem);
    if (err != cudaSuccess) return err;
    st.attr = true;
  }
  if (st.smem != smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &st.per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    st.smem = smem;
  }
  if (st.per_sm < 1) return cudaErrorInvalidConfiguration;
  const int resident = st.per_sm * info.sms;
  *grid = work < resident ? work : resident;
  return cudaSuccess;
}

template <int kR, bool kStatic>
KernelState g_dense_state[kMaxDevices];
template <int kR, bool kTable>
KernelState g_sparse_state[kMaxDevices];

template <int kR, bool kStatic>
cudaError_t launch_dense(const DeviceInfo& info, int tile, int smem,
                         cudaStream_t stream, const float* fit,
                         const float* req, const uint8_t* task_ok,
                         const uint8_t* feas, const float* idle,
                         const float* cap, const uint8_t* cap_ok,
                         const float* eps, const float* static_rows,
                         const int32_t* task_ids, int32_t* bid,
                         uint8_t* any_feas, int T, int N, int R, float lr_w,
                         float br_w) {
  int grid = 0;
  const cudaError_t err =
      prepare(bid_dense_kernel<kR, kStatic>, g_dense_state<kR, kStatic>, info,
              kDenseThreads, smem,
              (T + kDenseThreads / 32 - 1) / (kDenseThreads / 32), &grid);
  if (err != cudaSuccess) return err;
  bid_dense_kernel<kR, kStatic><<<grid, kDenseThreads, smem, stream>>>(
      fit, req, task_ok, feas, idle, cap, cap_ok, eps, static_rows, task_ids,
      bid, any_feas, T, N, R, tile, lr_w, br_w);
  return cudaGetLastError();
}

template <int kR, bool kTable>
cudaError_t launch_sparse(const DeviceInfo& info, int tile, int smem,
                          cudaStream_t stream, const float* fit,
                          const float* req, const uint8_t* task_ok,
                          const int32_t* cand, const float* cand_static,
                          const float* idle, const float* cap,
                          const uint8_t* cap_ok, const float* eps,
                          const int32_t* task_ids, int32_t* bid,
                          uint8_t* any_feas, int T, int N, int K, int R,
                          float lr_w, float br_w) {
  int grid = 0;
  const cudaError_t err =
      prepare(bid_sparse_kernel<kR, kTable>, g_sparse_state<kR, kTable>, info,
              sparse_threads(kR), smem,
              (T + sparse_threads(kR) / 16 - 1) / (sparse_threads(kR) / 16),
              &grid);
  if (err != cudaSuccess) return err;
  bid_sparse_kernel<kR, kTable><<<grid, sparse_threads(kR), smem, stream>>>(
      fit, req, task_ok, cand, cand_static, idle, cap, cap_ok, eps, task_ids,
      bid, any_feas, T, N, K, R, tile, lr_w, br_w);
  return cudaGetLastError();
}

int round16(int n) { return (n + 15) & ~15; }

}  // namespace

extern "C" {

// Returns the cudaError_t of the set-up and launch (0 on success).
int kbt_bid_dense(const float* fit, const float* req, const uint8_t* task_ok,
                  const uint8_t* feas, const float* idle, const float* cap,
                  const uint8_t* cap_ok, const float* eps,
                  const float* static_rows, const int32_t* task_ids,
                  int32_t* bid, uint8_t* any_feas, int T, int N, int R,
                  float lr_w, float br_w, void* stream) {
  if (T <= 0) return 0;
  if (R < 2 || R > kMaxR || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The widest tile (a multiple of 16 columns) whose table fits.
  const int per_slot = kNodeBytes2 + 4 * (R - 2);
  int tile = (info.smem / per_slot) * 16 / 17 / 16 * 16;
  if (tile > round16(N)) tile = round16(N);
  if (tile < 16) tile = 16;
  const int smem = table_bytes(tile, R);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 2) {
    err = static_rows
              ? launch_dense<2, true>(info, tile, smem, s, fit, req, task_ok,
                                      feas, idle, cap, cap_ok, eps,
                                      static_rows, task_ids, bid, any_feas, T,
                                      N, R, lr_w, br_w)
              : launch_dense<2, false>(info, tile, smem, s, fit, req, task_ok,
                                       feas, idle, cap, cap_ok, eps,
                                       static_rows, task_ids, bid, any_feas,
                                       T, N, R, lr_w, br_w);
  } else {
    err = static_rows
              ? launch_dense<0, true>(info, tile, smem, s, fit, req, task_ok,
                                      feas, idle, cap, cap_ok, eps,
                                      static_rows, task_ids, bid, any_feas, T,
                                      N, R, lr_w, br_w)
              : launch_dense<0, false>(info, tile, smem, s, fit, req, task_ok,
                                       feas, idle, cap, cap_ok, eps,
                                       static_rows, task_ids, bid, any_feas,
                                       T, N, R, lr_w, br_w);
  }
  return static_cast<int>(err);
}

int kbt_bid_sparse(const float* fit, const float* req, const uint8_t* task_ok,
                   const int32_t* cand, const float* cand_static,
                   const float* idle, const float* cap, const uint8_t* cap_ok,
                   const float* eps, const int32_t* task_ids, int32_t* bid,
                   uint8_t* any_feas, int T, int N, int K, int R, float lr_w,
                   float br_w, void* stream) {
  if (T <= 0) return 0;
  if (R < 2 || R > kMaxR || N < 0 || K < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The whole node table in shared memory when it fits, else gathers.
  const int tile = round16(N);
  const bool table = table_bytes(tile, R) <= info.smem;
  const int smem = table ? table_bytes(tile, R) : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 2) {
    err = table ? launch_sparse<2, true>(info, tile, smem, s, fit, req,
                                         task_ok, cand, cand_static, idle, cap,
                                         cap_ok, eps, task_ids, bid, any_feas,
                                         T, N, K, R, lr_w, br_w)
                : launch_sparse<2, false>(info, tile, smem, s, fit, req,
                                          task_ok, cand, cand_static, idle,
                                          cap, cap_ok, eps, task_ids, bid,
                                          any_feas, T, N, K, R, lr_w, br_w);
  } else {
    err = table ? launch_sparse<0, true>(info, tile, smem, s, fit, req,
                                         task_ok, cand, cand_static, idle, cap,
                                         cap_ok, eps, task_ids, bid, any_feas,
                                         T, N, K, R, lr_w, br_w)
                : launch_sparse<0, false>(info, tile, smem, s, fit, req,
                                          task_ok, cand, cand_static, idle,
                                          cap, cap_ok, eps, task_ids, bid,
                                          any_feas, T, N, K, R, lr_w, br_w);
  }
  return static_cast<int>(err);
}

}  // extern "C"
