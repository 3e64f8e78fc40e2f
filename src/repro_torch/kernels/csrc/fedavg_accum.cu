// K1: the Eq. 1 streaming FedAvg fold (paper §3.3), hand-written for Hopper.
//
//     out = (acc * N + theta * n) / (N + n)        (N + n == 0 -> out = acc)
//
// Replaces the Pallas TPU kernel repro/kernels/fedavg_accum.py:41
// fedavg_accum_2d.  Per element it does exactly that kernel's f32
// arithmetic in the same order; built with --fmad=false so the two
// multiplies and the add round on their own (no FMA contraction) and the
// division is IEEE, which makes it bitwise equal to the plain PyTorch
// version in f32.
//
// Bound: device memory.  2 reads + 1 write per element and 5 flops, far
// below the ~20 flop/byte an H100 needs before arithmetic matters.  The
// design therefore only moves bytes well:
//   * one launch folds L lanes at once: acc/theta/out are [L, n] row-major,
//     blockIdx.y picks the lane, and the lane's weights N, n are read from
//     device pointers (the counterpart of the TPU kernel's scalar prefetch —
//     the round never syncs the host to learn them);
//   * 16-byte vector loads/stores (float4, or 8 bf16) in a grid-stride
//     loop when every row starts 16-byte aligned, a scalar loop otherwise;
//   * out-of-place: the caller allocates `out`.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fold(float a, float t, float n_old, float n_k,
                                      float denom, bool live) {
  const float blended = (a * n_old + t * n_k) / denom;
  return live ? blended : a;
}

struct LaneWeights {
  float n_old, n_k, denom;
  bool live;
};

__device__ __forceinline__ LaneWeights lane_weights(const float* n_old,
                                                    const float* n_k,
                                                    int lane) {
  LaneWeights w;
  w.n_old = n_old[lane];
  w.n_k = n_k[lane];
  const float n_new = w.n_old + w.n_k;
  w.live = n_new > 0.0f;
  w.denom = w.live ? n_new : 1.0f;
  return w;
}

template <bool VEC>
__global__ void fedavg_accum_f32(const float* __restrict__ acc,
                                 const float* __restrict__ theta,
                                 float* __restrict__ out,
                                 const float* __restrict__ n_old,
                                 const float* __restrict__ n_k, long long n) {
  const int lane = blockIdx.y;
  const LaneWeights w = lane_weights(n_old, n_k, lane);
  const long long row = static_cast<long long>(lane) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (VEC) {
    const float4* a4 = reinterpret_cast<const float4*>(acc + row);
    const float4* t4 = reinterpret_cast<const float4*>(theta + row);
    float4* o4 = reinterpret_cast<float4*>(out + row);
    const long long n4 = n / 4;
    for (; i < n4; i += stride) {
      const float4 a = a4[i];
      const float4 t = t4[i];
      float4 r;
      r.x = fold(a.x, t.x, w.n_old, w.n_k, w.denom, w.live);
      r.y = fold(a.y, t.y, w.n_old, w.n_k, w.denom, w.live);
      r.z = fold(a.z, t.z, w.n_old, w.n_k, w.denom, w.live);
      r.w = fold(a.w, t.w, w.n_old, w.n_k, w.denom, w.live);
      o4[i] = r;
    }
  } else {
    for (; i < n; i += stride) {
      out[row + i] = fold(acc[row + i], theta[row + i], w.n_old, w.n_k,
                          w.denom, w.live);
    }
  }
}

__device__ __forceinline__ __nv_bfloat162 fold2(__nv_bfloat162 a,
                                                __nv_bfloat162 t,
                                                const LaneWeights& w) {
  const float2 af = __bfloat1622float2(a);
  const float2 tf = __bfloat1622float2(t);
  return __floats2bfloat162_rn(
      fold(af.x, tf.x, w.n_old, w.n_k, w.denom, w.live),
      fold(af.y, tf.y, w.n_old, w.n_k, w.denom, w.live));
}

template <bool VEC>
__global__ void fedavg_accum_bf16(const __nv_bfloat16* __restrict__ acc,
                                  const __nv_bfloat16* __restrict__ theta,
                                  __nv_bfloat16* __restrict__ out,
                                  const float* __restrict__ n_old,
                                  const float* __restrict__ n_k, long long n) {
  const int lane = blockIdx.y;
  const LaneWeights w = lane_weights(n_old, n_k, lane);
  const long long row = static_cast<long long>(lane) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (VEC) {
    // 16 bytes = 8 bf16 = 4 bf16 pairs per thread and iteration.
    const uint4* a8 = reinterpret_cast<const uint4*>(acc + row);
    const uint4* t8 = reinterpret_cast<const uint4*>(theta + row);
    uint4* o8 = reinterpret_cast<uint4*>(out + row);
    const long long n8 = n / 8;
    for (; i < n8; i += stride) {
      uint4 a = a8[i];
      uint4 t = t8[i];
      uint4 r;
      const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* tp = reinterpret_cast<const __nv_bfloat162*>(&t);
      __nv_bfloat162* rp = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int k = 0; k < 4; ++k) rp[k] = fold2(ap[k], tp[k], w);
      o8[i] = r;
    }
  } else {
    for (; i < n; i += stride) {
      out[row + i] = __float2bfloat16_rn(
          fold(__bfloat162float(acc[row + i]), __bfloat162float(theta[row + i]),
               w.n_old, w.n_k, w.denom, w.live));
    }
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocksPerLane = 1024;

}  // namespace

// acc, theta, out: [lanes, n] row-major, all of one dtype (0 = f32,
// 1 = bf16); n_old, n_k: [lanes] f32 on the device.  vec != 0 asserts that
// every row of all three starts 16-byte aligned.  Returns cudaGetLastError().
extern "C" int pollen_fedavg_accum(const void* acc, const void* theta,
                                   void* out, const float* n_old,
                                   const float* n_k, long long lanes,
                                   long long n, int dtype, int vec,
                                   void* stream) {
  if (lanes <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (lanes > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_vec = dtype == 0 ? 4 : 8;
  const long long units = vec ? n / per_vec : n;
  long long bx = (units + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerLane) bx = kMaxBlocksPerLane;
  if (bx < 1) bx = 1;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(lanes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const float* a = static_cast<const float*>(acc);
    const float* t = static_cast<const float*>(theta);
    float* o = static_cast<float*>(out);
    if (vec) {
      fedavg_accum_f32<true><<<grid, kThreads, 0, s>>>(a, t, o, n_old, n_k, n);
    } else {
      fedavg_accum_f32<false><<<grid, kThreads, 0, s>>>(a, t, o, n_old, n_k, n);
    }
  } else {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(acc);
    const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(theta);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec) {
      fedavg_accum_bf16<true><<<grid, kThreads, 0, s>>>(a, t, o, n_old, n_k, n);
    } else {
      fedavg_accum_bf16<false><<<grid, kThreads, 0, s>>>(a, t, o, n_old, n_k, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pollen_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
