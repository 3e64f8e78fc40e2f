// K3: RMSNorm over the last dim, hand-written for Hopper.  Per row of a
// [rows, d] matrix:
//
//     out = x * rsqrt(mean(x^2) + eps) * scale        (f32 math, out in x's type)
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py:30 rmsnorm_2d.  The
// sum of squares is taken in f32, the row is scaled in f32 in the TPU
// kernel's order ((x * r) * scale) and rounded once to the output type.
//
// Bound: device memory.  One read and one write of x per element (2 bytes
// each in bf16) against 4 flops, far below the flop/byte an H100 needs before
// arithmetic matters.  The design keeps the row out of device memory between
// its two passes and never syncs the host:
//   * one warp per row, 8 rows per block: the sum of squares is a warp
//     reduction (xor shuffles), so no shared memory and no block barrier;
//   * the second pass (scale and store) reads the row again; a block's 8
//     rows (16 KB at d = 1024 in bf16) are still in L1, so device memory sees
//     one read per element;
//   * 16-byte loads and stores (8 bf16 or 4 f32 a lane) where every row
//     starts 16-byte aligned, one element a lane otherwise;
//   * the f32 scale [d] is read through L1 by every warp.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* yr = out + row * d;

  float ss = 0.0f;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / N; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = to_f32(xr[c]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / N; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        o[j] = from_f32<T>(to_f32(e[j]) * r * scale[i * N + j]);
      }
      yv[i] = packed;
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      yr[c] = from_f32<T>(to_f32(xr[c]) * r * scale[c]);
    }
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows,
           int d, float eps, int vec, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec) {
    rmsnorm_rows<T, true><<<grid, kWarps * 32, 0, stream>>>(xt, scale, ot,
                                                            rows, d, eps);
  } else {
    rmsnorm_rows<T, false><<<grid, kWarps * 32, 0, stream>>>(xt, scale, ot,
                                                             rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, d] row-major, dtype 0 = f32, 1 = bf16; scale: f32 [d].
// vec != 0 asserts that x and out start 16-byte aligned and that a row is a
// whole number of 16-byte vectors.  Returns cudaGetLastError().
extern "C" int pollen_rmsnorm(const void* x, const float* scale, void* out,
                              long long rows, int d, float eps, int dtype,
                              int vec, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, rows, d, eps, vec, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pollen_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
