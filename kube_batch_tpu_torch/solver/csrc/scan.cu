// Hopper (sm_90a) kernel for the solver's segmented prefix sum, with a plain
// C interface for ctypes (kube_batch_tpu_torch/solver/kernels.py,
// `segmented_cumsum`).
//
// It replaces no Pallas kernel: in the reference the sum is XLA's
// `jax.lax.associative_scan` (kube_batch_tpu/solver/kernels.py,
// `segmented_cumsum`), which the port's plain version `_associative_scan`
// repeats as about 140 eager torch ops, each its own launch. Here it is one
// launch. The work is a few tens of kilobytes (T x R floats and T flags,
// T ~ 1,280 in a slab round), so the bound is the launch itself.
//
// The result is out[t] = inclusive sum of x over t's segment (segments start
// where is_start), with exactly the association of the odd/even recursion,
// so the floats are bit-equal to the plain version and to the JAX package:
//   - pairs reduce as (e[2i], e[2i+1]), and the scan recurses on them;
//   - out[2i+1] = odd[i], out[2i] = odd[i-1] (+) e[2i], out[0] = e[0];
//   - (a_f, a_v) (+) (b_f, b_v) = (a_f | b_f, b_f ? b_v : a_v + b_v);
//   - an odd length leaves its last element out of the pairs.
// In place, level k of the recursion holds its element i at position
// 2^k (i + 1) - 1 (the pair of element i at level k + 1 is the nodes at
// j - 2^k and j = 2^(k+1) (i + 1) - 1, which exists iff j < T): the up-sweep
// and down-sweep of a work-efficient scan, the down-sweep at stride s
// setting nodes j = s (2i + 1) - 1, i >= 1, from node j - s.
//
// Design:
// - A tile is kTile = 4,096 consecutive elements of one column, aligned to
//   kTile. Its values and flags sit in shared memory (20 KB); a sweep level
//   is one pass of the block's threads and one barrier.
// - T <= kTile (every slab-round commit): one block per column runs the
//   whole scan in its tile.
// - T > kTile: the recursion below level log2(kTile) stays inside aligned
//   tiles, and level log2(kTile) is the sequence of full tiles' totals. So:
//   up-sweep every full tile and write its total (level 1 of the tiled
//   recursion); repeat on the totals while they are more than kTile; scan
//   the last level in one tile; then, from the top down, redo each tile's
//   up-sweep and run its down-sweep, whose nodes j = s - 1 (the tile's
//   first even element at every stride) take the previous tile's scanned
//   total as the left operand, and whose last element is its own scanned
//   total. One cooperative launch; the phases meet at grid barriers; the
//   totals live in a scratch buffer the caller allocates
//   (kbt_seg_cumsum_scratch_bytes).
// Numerics: built with --fmad=false like the bid kernels; the one float
// operation is an IEEE add, so any device gives the CPU's bits.

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 4096;
constexpr int kScanThreads = 512;
// Levels of tile totals: T < 2^31 <= kTile^3 needs at most 2.
constexpr int kMaxLevels = 3;
constexpr int kMaxScanDevices = 64;

struct ScanArgs {
  const float* x;
  const uint8_t* starts;
  float* out;
  int R;
  int depth;  // tiled levels below the top: 0 when T <= kTile
  int n[kMaxLevels + 1];
  // Levels 1..depth: totals [n[l], R] and their flags [n[l]].
  float* tot[kMaxLevels + 1];
  uint8_t* tflag[kMaxLevels + 1];
};

// 16-byte aligned offsets of each level's totals in the scratch buffer.
size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// Fills n, depth and (when base is non-null) the level pointers; returns the
// scratch bytes the levels need.
size_t plan(ScanArgs* a, int T, int R, unsigned char* base) {
  a->n[0] = T;
  a->depth = 0;
  size_t bytes = 0;
  while (a->n[a->depth] > kTile) {
    const int l = ++a->depth;
    a->n[l] = a->n[l - 1] / kTile;
    const size_t vbytes = align16(sizeof(float) * a->n[l] * R);
    if (base) {
      a->tot[l] = reinterpret_cast<float*>(base + bytes);
      a->tflag[l] = base + bytes + vbytes;
    }
    bytes += vbytes + align16(a->n[l]);
  }
  return bytes;
}

__device__ __forceinline__ const float* level_src(const ScanArgs& a, int l) {
  return l == 0 ? a.x : a.tot[l];
}
__device__ __forceinline__ const uint8_t* level_flags(const ScanArgs& a,
                                                      int l) {
  return l == 0 ? a.starts : a.tflag[l];
}
__device__ __forceinline__ float* level_dst(const ScanArgs& a, int l) {
  return l == 0 ? a.out : a.tot[l];
}

// Loads column c of the tile at `base` (cnt elements) and runs its
// up-sweep. Totals of other blocks may have been written in this launch, so
// the loads bypass L1 (ld.global.cg).
__device__ __forceinline__ void load_upsweep(float* v, uint8_t* f,
                                             const float* src,
                                             const uint8_t* flags, int R,
                                             int c, int base, int cnt) {
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    v[i] = __ldcg(src + static_cast<size_t>(base + i) * R + c);
    f[i] = __ldcg(flags + base + i) != 0;
  }
  __syncthreads();
  for (int s = 1; 2 * s <= cnt; s <<= 1) {
    const int pairs = cnt / (2 * s);
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const int j = 2 * s * (i + 1) - 1;
      const int l = j - s;
      const uint8_t fb = f[j];
      v[j] = fb ? v[j] : v[l] + v[j];
      f[j] = f[l] | fb;
    }
    __syncthreads();
  }
}

// Down-sweep of an up-swept tile. With `seeded`, the element before the
// tile is `seed` (the previous tile's scanned total) and each stride's node
// s - 1 takes it as its left operand; without, the tile starts the column.
__device__ __forceinline__ void downsweep(float* v, const uint8_t* f,
                                          int cnt, bool seeded, float seed) {
  int top = 1;
  while (2 * top <= cnt && 2 * top <= kTile / 2) top <<= 1;
  const int first = seeded ? 0 : 1;
  for (int s = top; s >= 1; s >>= 1) {
    for (int i = first + threadIdx.x; s * (2 * i + 1) <= cnt;
         i += blockDim.x) {
      const int j = s * (2 * i + 1) - 1;
      const float a = i == 0 ? seed : v[j - s];
      v[j] = f[j] ? v[j] : a + v[j];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store(float* dst, const float* v, int R,
                                      int c, int base, int cnt) {
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    dst[static_cast<size_t>(base + i) * R + c] = v[i];
  }
}

// The top level (n[depth] <= kTile elements): one tile per column, scanned
// whole.
__device__ __forceinline__ void scan_top(const ScanArgs& a, float* v,
                                         uint8_t* f) {
  const int l = a.depth;
  const int cnt = a.n[l];
  for (int c = blockIdx.x; c < a.R; c += gridDim.x) {
    load_upsweep(v, f, level_src(a, l), level_flags(a, l), a.R, c, 0, cnt);
    downsweep(v, f, cnt, false, 0.0f);
    store(level_dst(a, l), v, a.R, c, 0, cnt);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScanThreads)
    seg_cumsum_kernel(ScanArgs a) {
  __shared__ float v[kTile];
  __shared__ uint8_t f[kTile];
  scan_top(a, v, f);
}

__global__ void __launch_bounds__(kScanThreads)
    seg_cumsum_tiled_kernel(ScanArgs a) {
  __shared__ float v[kTile];
  __shared__ uint8_t f[kTile];
  cg::grid_group grid = cg::this_grid();
  const int R = a.R;
  // Up: each full tile's total becomes an element of the next level.
  for (int l = 0; l < a.depth; ++l) {
    const int items = a.n[l + 1] * R;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int t = it / R;
      const int c = it - t * R;
      load_upsweep(v, f, level_src(a, l), level_flags(a, l), R, c,
                   t * kTile, kTile);
      if (threadIdx.x == 0) {
        a.tot[l + 1][static_cast<size_t>(t) * R + c] = v[kTile - 1];
        if (c == 0) a.tflag[l + 1][t] = f[kTile - 1];
      }
      __syncthreads();
    }
    grid.sync();
  }
  scan_top(a, v, f);
  // Down: each tile, partial ones included, from the scanned totals above.
  for (int l = a.depth - 1; l >= 0; --l) {
    grid.sync();
    const int n = a.n[l];
    const int tiles = (n + kTile - 1) / kTile;
    const float* above = a.tot[l + 1];
    for (int it = blockIdx.x; it < tiles * R; it += gridDim.x) {
      const int t = it / R;
      const int c = it - t * R;
      const int base = t * kTile;
      const int cnt = n - base < kTile ? n - base : kTile;
      load_upsweep(v, f, level_src(a, l), level_flags(a, l), R, c, base,
                   cnt);
      const float seed =
          t > 0 ? __ldcg(above + static_cast<size_t>(t - 1) * R + c) : 0.0f;
      downsweep(v, f, cnt, t > 0, seed);
      if (cnt == kTile && threadIdx.x == 0) {
        v[kTile - 1] = __ldcg(above + static_cast<size_t>(t) * R + c);
      }
      __syncthreads();
      store(level_dst(a, l), v, R, c, base, cnt);
      __syncthreads();
    }
  }
}

std::mutex g_scan_mu;
int g_resident[kMaxScanDevices];  // blocks of the tiled kernel on the card

cudaError_t resident_blocks(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxScanDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_scan_mu);
  if (g_resident[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorCooperativeLaunchTooLarge;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_cumsum_tiled_kernel, kScanThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    g_resident[dev] = per_sm * sms;
  }
  *out = g_resident[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch bytes kbt_seg_cumsum needs for T rows of R columns (0 when
// T <= 4,096).
size_t kbt_seg_cumsum_scratch_bytes(int T, int R) {
  ScanArgs a{};
  return T > 0 && R > 0 ? plan(&a, T, R, nullptr) : 0;
}

// out[T, R] = the segmented inclusive prefix sum of x[T, R] (row-major,
// float32) along rows, restarting where starts[t] (uint8 0/1). Returns the
// cudaError_t of the set-up and launch (0 on success).
int kbt_seg_cumsum(const float* x, const uint8_t* starts, float* out,
                   void* scratch, size_t scratch_bytes, int T, int R,
                   void* stream) {
  if (T <= 0) return 0;
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a{};
  a.x = x;
  a.starts = starts;
  a.out = out;
  a.R = R;
  if (plan(&a, T, R, static_cast<unsigned char*>(scratch)) > scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.depth == 0) {
    seg_cumsum_kernel<<<R, kScanThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = ((T + kTile - 1) / kTile) * R;
  const int grid = work < resident ? work : resident;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)seg_cumsum_tiled_kernel,
                                    dim3(grid), dim3(kScanThreads), params,
                                    0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
