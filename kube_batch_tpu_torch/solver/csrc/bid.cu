// Hopper (sm_90a) kernels for the solver's fused bid pass, with a plain C
// interface for ctypes (kube_batch_tpu_torch/solver/bid_kernels.py).
//
// kbt_bid_dense replaces the Pallas TPU kernel `pallas_bid` / `_bid_kernel`
// (kube_batch_tpu/solver/pallas_kernels.py:44-219); kbt_bid_sparse replaces
// `pallas_bid_sparse` / `_sparse_bid_kernel` (pallas_kernels.py:223-393).
// Each computes, per task row: the epsilon fit `fit - idle < eps` over all R
// dimensions, AND the static feasibility, node pod-count capacity and task
// gate, LeastRequested + Balanced on (cpu, mem) plus the optional static
// score, the integer bid key (quantized score << 10 | hash10(task, node)),
// and the row's best key with the lowest column (dense) or lowest global node
// id (sparse) among ties. Outputs: bid i32[T] (N when nothing is feasible)
// and any_feas u8[T].
//
// What bounds them on an H100: memory. The dense pass reads the [T, N] bool
// feasibility row once (T*N bytes, 250 MB at 50k x 5k) plus the static rows
// when present (4*T*N bytes); the sparse pass reads the [T, K] slab of node
// ids and static scores (8*T*K bytes) and gathers idle/cap by node id. The
// arithmetic is a few dozen flops per cell. The Pallas kernel held all of
// idle/cap [N, R] in VMEM; here one warp takes one task row, its lanes stride
// across the row (coalesced byte reads of feas, float reads of the static
// row), idle/cap come through L1/L2 (40 KB at 5k nodes x R=2), and a warp
// shuffle reduces (max key, lowest column). One row per warp keeps every
// reduction inside the warp, so no shared memory and no second pass.
//
// Numerics: the keys must be bit-equal to the plain PyTorch version and to
// the JAX package as XLA compiles it. Built with --fmad=false, so no product
// is contracted implicitly; the two products XLA does contract into fused
// multiply-adds (10 - diff*10 and lr_w*lr + br_w*br) are explicit
// __fmaf_rn; XLA's `score / 0.02` is `score * 50` (the float32 reciprocal
// rounds to exactly 50); rintf rounds half to even like jnp.round; the hash
// runs in uint32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxR = 8;
constexpr float kMaxPriority = 10.0f;
constexpr float kInvQuantum = 50.0f;
constexpr float kKeyBias = 524288.0f;    // 1 << 19
constexpr float kKeyMax = 1048575.0f;    // (1 << 20) - 1
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int32_t bid_hash(uint32_t t, uint32_t n) {
  uint32_t x = (t * 2654435761u) ^ (n * 0x9E3779B9u);
  x ^= x >> 13;
  x *= 2246822519u;
  return static_cast<int32_t>((x >> 8) & 1023u);
}

__device__ __forceinline__ float least_requested(float rem, float cap,
                                                 float safe) {
  return cap > 0.0f
             ? __fdiv_rn(__fmul_rn(fmaxf(rem, 0.0f), kMaxPriority), safe)
             : 0.0f;
}

// LeastRequested + Balanced on (cpu, mem) in the JAX package's order.
__device__ __forceinline__ float dyn_score(float req_c, float req_m,
                                           float idle_c, float idle_m,
                                           float cap_c, float cap_m,
                                           float lr_w, float br_w) {
  const float safe_c = cap_c > 0.0f ? cap_c : 1.0f;
  const float safe_m = cap_m > 0.0f ? cap_m : 1.0f;
  const float rem_c = __fsub_rn(idle_c, req_c);
  const float rem_m = __fsub_rn(idle_m, req_m);
  const float lr = __fmul_rn(
      __fadd_rn(least_requested(rem_c, cap_c, safe_c),
                least_requested(rem_m, cap_m, safe_m)),
      0.5f);
  const float frac_c =
      cap_c > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(rem_c, safe_c)) : 1.0f;
  const float frac_m =
      cap_m > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(rem_m, safe_m)) : 1.0f;
  const float diff = fabsf(__fsub_rn(frac_c, frac_m));
  const float br = (frac_c >= 1.0f || frac_m >= 1.0f)
                       ? 0.0f
                       : __fmaf_rn(-diff, kMaxPriority, kMaxPriority);
  return __fmaf_rn(br_w, br, __fmul_rn(lr, lr_w));
}

__device__ __forceinline__ int32_t make_key(float score, uint32_t t,
                                            uint32_t n) {
  float q = rintf(__fmul_rn(score, kInvQuantum));
  q = fminf(fmaxf(__fadd_rn(q, kKeyBias), 0.0f), kKeyMax);
  return (static_cast<int32_t>(q) << 10) | bid_hash(t, n);
}

struct TaskRow {
  float fit[kMaxR];
  float eps[kMaxR];
  float req_c, req_m;
  uint32_t tid;
};

__device__ __forceinline__ void load_row(TaskRow& tr, const float* fit,
                                         const float* req, const float* eps,
                                         const int32_t* task_ids, int row,
                                         int R) {
#pragma unroll
  for (int d = 0; d < kMaxR; ++d) {
    tr.fit[d] = d < R ? fit[static_cast<size_t>(row) * R + d] : 0.0f;
    tr.eps[d] = d < R ? eps[d] : 1.0f;
  }
  tr.req_c = req[static_cast<size_t>(row) * R + 0];
  tr.req_m = req[static_cast<size_t>(row) * R + 1];
  tr.tid = static_cast<uint32_t>(task_ids[row]);
}

__device__ __forceinline__ bool fits_node(const TaskRow& tr,
                                          const float* idle_j, int R) {
  bool ok = true;
#pragma unroll
  for (int d = 0; d < kMaxR; ++d) {
    if (d < R) ok = ok && (__fsub_rn(tr.fit[d], idle_j[d]) < tr.eps[d]);
  }
  return ok;
}

// Warp-wide (max key, then lowest id); lane 0 writes the row's result.
__device__ __forceinline__ void reduce_and_store(int32_t best_key,
                                                 int32_t best_id, int lane,
                                                 int row, int N, int32_t* bid,
                                                 uint8_t* any_feas) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t k2 = __shfl_down_sync(kFullMask, best_key, off);
    const int32_t i2 = __shfl_down_sync(kFullMask, best_id, off);
    if (k2 > best_key || (k2 == best_key && i2 < best_id)) {
      best_key = k2;
      best_id = i2;
    }
  }
  if (lane == 0) {
    const bool has = best_key >= 0;
    bid[row] = has ? best_id : N;
    any_feas[row] = has ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bid_dense_kernel(const float* __restrict__ fit, const float* __restrict__ req,
                 const uint8_t* __restrict__ task_ok,
                 const uint8_t* __restrict__ feas,
                 const float* __restrict__ idle, const float* __restrict__ cap,
                 const uint8_t* __restrict__ cap_ok,
                 const float* __restrict__ eps,
                 const float* __restrict__ static_rows,
                 const int32_t* __restrict__ task_ids, int32_t* bid,
                 uint8_t* any_feas, int T, int N, int R, float lr_w,
                 float br_w) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T) return;  // warp-uniform: one row per warp
  int32_t best_key = -1;
  int32_t best_col = N;
  if (task_ok[row]) {
    TaskRow tr;
    load_row(tr, fit, req, eps, task_ids, row, R);
    const uint8_t* frow = feas + static_cast<size_t>(row) * N;
    const float* srow =
        static_rows ? static_rows + static_cast<size_t>(row) * N : nullptr;
    for (int j = lane; j < N; j += 32) {
      if (!frow[j] || !cap_ok[j]) continue;
      const float* idle_j = idle + static_cast<size_t>(j) * R;
      if (!fits_node(tr, idle_j, R)) continue;
      const float* cap_j = cap + static_cast<size_t>(j) * R;
      float score = dyn_score(tr.req_c, tr.req_m, idle_j[0], idle_j[1],
                              cap_j[0], cap_j[1], lr_w, br_w);
      if (srow) score = __fadd_rn(score, srow[j]);
      const int32_t key = make_key(score, tr.tid, static_cast<uint32_t>(j));
      // Columns ascend along a lane, so a strict > keeps the lowest.
      if (key > best_key) {
        best_key = key;
        best_col = j;
      }
    }
  }
  reduce_and_store(best_key, best_col, lane, row, N, bid, any_feas);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bid_sparse_kernel(const float* __restrict__ fit, const float* __restrict__ req,
                  const uint8_t* __restrict__ task_ok,
                  const int32_t* __restrict__ cand,
                  const float* __restrict__ cand_static,
                  const float* __restrict__ idle,
                  const float* __restrict__ cap,
                  const uint8_t* __restrict__ cap_ok,
                  const float* __restrict__ eps,
                  const int32_t* __restrict__ task_ids, int32_t* bid,
                  uint8_t* any_feas, int T, int N, int K, int R, float lr_w,
                  float br_w) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= T) return;
  int32_t best_key = -1;
  int32_t best_id = N;
  if (task_ok[row]) {
    TaskRow tr;
    load_row(tr, fit, req, eps, task_ids, row, R);
    const int32_t* crow = cand + static_cast<size_t>(row) * K;
    const float* srow = cand_static + static_cast<size_t>(row) * K;
    for (int k = lane; k < K; k += 32) {
      const int32_t j = crow[k];
      if (j < 0 || j >= N) continue;  // padding id: never dereferenced
      if (!cap_ok[j]) continue;
      const float* idle_j = idle + static_cast<size_t>(j) * R;
      if (!fits_node(tr, idle_j, R)) continue;
      const float* cap_j = cap + static_cast<size_t>(j) * R;
      const float score = __fadd_rn(
          dyn_score(tr.req_c, tr.req_m, idle_j[0], idle_j[1], cap_j[0],
                    cap_j[1], lr_w, br_w),
          srow[k]);
      const int32_t key = make_key(score, tr.tid, static_cast<uint32_t>(j));
      if (key > best_key || (key == best_key && j < best_id)) {
        best_key = key;
        best_id = j;
      }
    }
  }
  reduce_and_store(best_key, best_id, lane, row, N, bid, any_feas);
}

inline dim3 grid_for(int T) {
  return dim3((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int kbt_bid_dense(const float* fit, const float* req, const uint8_t* task_ok,
                  const uint8_t* feas, const float* idle, const float* cap,
                  const uint8_t* cap_ok, const float* eps,
                  const float* static_rows, const int32_t* task_ids,
                  int32_t* bid, uint8_t* any_feas, int T, int N, int R,
                  float lr_w, float br_w, void* stream) {
  if (T <= 0) return 0;
  if (R < 2 || R > kMaxR || N < 0) return static_cast<int>(cudaErrorInvalidValue);
  bid_dense_kernel<<<grid_for(T), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      fit, req, task_ok, feas, idle, cap, cap_ok, eps, static_rows, task_ids,
      bid, any_feas, T, N, R, lr_w, br_w);
  return static_cast<int>(cudaGetLastError());
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
  bid_sparse_kernel<<<grid_for(T), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      fit, req, task_ok, cand, cand_static, idle, cap, cap_ok, eps, task_ids,
      bid, any_feas, T, N, K, R, lr_w, br_w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
