// K2: the compressed combine's fold (paper §3.3 with int8 uploads),
// hand-written for Hopper.  Per element of a flat multi-leaf buffer:
//
//     theta = g + q * scale[leaf]                 (int8 dequantize)
//     out   = (acc * N + theta * n) / (N + n)     (Eq. 1; N + n == 0 -> acc)
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_merge.py:46
// dequant_merge_2d.  Per element it does exactly that kernel's f32
// arithmetic in the same order; built with --fmad=false, so every multiply
// and add rounds on its own and the division is IEEE: bitwise equal to the
// plain PyTorch version in f32.
//
// Bound: device memory.  13 bytes per element (acc f32, q int8 and g f32
// read once, out f32 written once) against 6 flops, far below the ~20
// flop/byte an H100 needs before arithmetic matters.  The design moves
// bytes and never syncs the host:
//   * one launch folds ONE shard's payload over every leaf of the model:
//     acc, g and out are the flat f32 [N] buffers, q the flat int8 [N]
//     payload, with a per-leaf scale table (f32 [L]) and leaf offsets
//     (int64 [L+1]) on the device;
//   * each block copies the two tables into shared memory and finds a
//     thread's leaf by binary search over the offsets;
//   * the weights N, n are read through device pointers (the counterpart
//     of the TPU kernel's scalar prefetch);
//   * a thread folds 4 neighbouring elements at a time — one float4 load
//     each of acc and g, one 4-byte load of q, one float4 store — so a
//     warp reads 512 contiguous bytes of each f32 buffer per instruction;
//     element by element where the 4 straddle a leaf edge or the buffers
//     are not 16-byte aligned;
//   * out of place: the caller allocates `out`.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnit = 4;               // elements per thread and iteration
constexpr long long kMaxBlocks = 4096;
constexpr int kMaxLeaves = 2048;       // shared tables: 24.6 KB at most

struct Weights {
  float n_old, n_k, denom;
  bool live;
};

__device__ __forceinline__ float blend(float a, float g, float q, float scale,
                                       const Weights& w) {
  const float theta = g + q * scale;
  const float blended = (a * w.n_old + theta * w.n_k) / w.denom;
  return w.live ? blended : a;
}

// Largest l in [0, n_leaves) with off[l] <= i (skips empty leaves).
__device__ __forceinline__ int find_leaf(const long long* off, int n_leaves,
                                         long long i) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

template <bool VEC>
__global__ void dequant_merge_f32(const float* __restrict__ acc,
                                  const int8_t* __restrict__ q,
                                  const float* __restrict__ g,
                                  float* __restrict__ out,
                                  const float* __restrict__ scales,
                                  const long long* __restrict__ offsets,
                                  int n_leaves, long long n,
                                  const float* __restrict__ n_old,
                                  const float* __restrict__ n_k) {
  extern __shared__ long long smem[];
  long long* s_off = smem;
  float* s_scale = reinterpret_cast<float*>(smem + n_leaves + 1);
  for (int i = threadIdx.x; i <= n_leaves; i += blockDim.x) {
    s_off[i] = offsets[i];
  }
  for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) {
    s_scale[i] = scales[i];
  }
  __syncthreads();

  Weights w;
  w.n_old = *n_old;
  w.n_k = *n_k;
  const float n_new = w.n_old + w.n_k;
  w.live = n_new > 0.0f;
  w.denom = w.live ? n_new : 1.0f;

  const long long units = (n + kUnit - 1) / kUnit;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += stride) {
    const long long i0 = u * kUnit;
    int leaf = find_leaf(s_off, n_leaves, i0);
    if (VEC && i0 + kUnit <= s_off[leaf + 1]) {
      const float scale = s_scale[leaf];
      const float4 a = reinterpret_cast<const float4*>(acc)[u];
      const float4 gg = reinterpret_cast<const float4*>(g)[u];
      const char4 qq = reinterpret_cast<const char4*>(q)[u];
      float4 r;
      r.x = blend(a.x, gg.x, static_cast<float>(qq.x), scale, w);
      r.y = blend(a.y, gg.y, static_cast<float>(qq.y), scale, w);
      r.z = blend(a.z, gg.z, static_cast<float>(qq.z), scale, w);
      r.w = blend(a.w, gg.w, static_cast<float>(qq.w), scale, w);
      reinterpret_cast<float4*>(out)[u] = r;
    } else {
      const long long end = i0 + kUnit < n ? i0 + kUnit : n;
      for (long long i = i0; i < end; ++i) {
        while (leaf + 1 < n_leaves && i >= s_off[leaf + 1]) ++leaf;
        out[i] = blend(acc[i], g[i], static_cast<float>(q[i]),
                       s_scale[leaf], w);
      }
    }
  }
}

}  // namespace

// acc, g, out: f32 [n]; q: int8 [n]; scales: f32 [n_leaves]; offsets:
// int64 [n_leaves + 1] with offsets[0] == 0 and offsets[n_leaves] == n;
// n_old, n_k: one f32 each, on the device.  vec != 0 asserts that acc, q,
// g and out all start 16-byte aligned.  Returns cudaGetLastError().
extern "C" int pollen_dequant_merge(const float* acc, const int8_t* q,
                                    const float* g, float* out,
                                    const float* scales,
                                    const long long* offsets, int n_leaves,
                                    long long n, const float* n_old,
                                    const float* n_k, int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (n_leaves < 1 || n_leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = (n + kUnit - 1) / kUnit;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = sizeof(long long) * (n_leaves + 1) +
                      sizeof(float) * n_leaves;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec) {
    dequant_merge_f32<true><<<grid, kThreads, smem, s>>>(
        acc, q, g, out, scales, offsets, n_leaves, n, n_old, n_k);
  } else {
    dequant_merge_f32<false><<<grid, kThreads, smem, s>>>(
        acc, q, g, out, scales, offsets, n_leaves, n, n_old, n_k);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pollen_dequant_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
