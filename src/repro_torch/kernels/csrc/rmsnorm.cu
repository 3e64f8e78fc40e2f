// K3: RMSNorm over the last dim, hand-written for Hopper.  Per row of a
// [rows, d] matrix:
//
//     out = x * rsqrt(mean(x^2) + eps) * scale   (f32 math, out in x's type)
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py:30 rmsnorm_2d.  The
// sum of squares is taken in f32, the row is scaled in f32 in the TPU
// kernel's order ((x * r) * scale) and rounded once to the output type.
//
// Bound: device memory.  One read and one write of x per element (2 bytes
// each in bf16) against 4 flops, far below the flop/byte an H100 needs before
// arithmetic matters.  So every element is read from device memory once and
// written once, and enough loads are kept in flight to cover the latency:
//   * the row-in-registers kernel, for rows of whole 16-byte vectors (8 bf16
//     or 4 f32) of at most 32 x 4 vectors (d <= 1024 in bf16, 512 in f32):
//     - a row is held by lanes_per_row = min(32, next_pow2(d / 8 or 4))
//       lanes, so at d = 128 in bf16 a warp takes two rows of 16 lanes and
//       none idles; the sum of squares is a shuffle reduction of that width;
//     - each lane keeps its vectors of the row in registers between the sum
//       and the store (no second read, no reliance on L1);
//     - each lane loads its slice of the f32 scale once, as float4s, and
//       keeps it in registers for every row it handles;
//     - warps walk rows in a grid-stride loop over a grid sized to the SMs,
//       and issue the next row's loads before this row's reduction;
//   * the loop kernel (one warp per row, the row read twice through L1) for
//     longer rows, and element by element for rows that are no whole number
//     of vectors, or where x, out or the scale starts off 16-byte alignment
//     (the wrapper's vector_ok decides; a misaligned scale, such as a view
//     into a packed flat tree, takes the element path and is not copied).
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
    rmsnorm_loop(const T* __restrict__ x, const float* __restrict__ scale,
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

constexpr int kMaxVecs = 4;  // vectors per lane on the register path

// How a row of d elements of `bytes`-byte type is laid out over lanes.
struct Geometry {
  int path;           // 0 element by element, 1 loop, 2 registers
  int lanes_per_row;  // lanes that share one row
  int vecs;           // 16-byte vectors a lane holds (register path)
};

Geometry geometry(int d, int bytes, int vec) {
  if (!vec) return {0, 32, 0};
  const int n_vec = d / (16 / bytes);
  int lanes = 1;
  while (lanes < n_vec && lanes < 32) lanes *= 2;
  int vecs = 1;
  while (vecs * lanes < n_vec) vecs *= 2;
  if (vecs > kMaxVecs) return {1, 32, 0};
  return {2, lanes, vecs};
}

template <typename T, int V>
__device__ __forceinline__ void load_row(uint4 (&buf)[V], const T* x,
                                         long long row, long long rows, int d,
                                         int sub, int lanes, int n_vec) {
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = sub + i * lanes;
    buf[i] = (row < rows && c < n_vec) ? xv[c] : make_uint4(0, 0, 0, 0);
  }
}

// Rows of whole 16-byte vectors, each held in registers by `lanes` lanes
// (a power of two <= 32) with V vectors a lane.
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
    rmsnorm_regs(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ out, long long rows, int d, float eps,
                 int lanes) {
  constexpr int N = 16 / sizeof(T);  // elements per vector
  const int n_vec = d / N;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);  // this lane's place in its row
  const int rows_per_warp = 32 / lanes;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long step =
      (static_cast<long long>(gridDim.x) * blockDim.x >> 5) * rows_per_warp;
  const long long first = warp * rows_per_warp + lane / lanes;

  float sc[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = sub + i * lanes;
    const float4* sv = reinterpret_cast<const float4*>(scale + c * N);
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 f = c < n_vec ? sv[j / 4] : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[i][j] = f.x;
      sc[i][j + 1] = f.y;
      sc[i][j + 2] = f.z;
      sc[i][j + 3] = f.w;
    }
  }

  uint4 cur[V];
  load_row<T, V>(cur, x, first, rows, d, sub, lanes, n_vec);
  // The loop bound is the warp's first row, so every lane of the warp runs
  // every shuffle; a group whose row is past the end stores nothing.
  for (long long row = first, head = warp * rows_per_warp; head < rows;
       row += step, head += step) {
    uint4 nxt[V];
    load_row<T, V>(nxt, x, row + step, rows, d, sub, lanes, n_vec);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const T* e = reinterpret_cast<const T*>(&cur[i]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (row < rows) {
      uint4* yv = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = sub + i * lanes;
        if (c >= n_vec) continue;
        const T* e = reinterpret_cast<const T*>(&cur[i]);
        uint4 packed;
        T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          o[j] = from_f32<T>(to_f32(e[j]) * r * sc[i][j]);
        }
        yv[c] = packed;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0) {
      return 132;
    }
    count[dev] = n;
  }
  return count[dev];
}

template <typename T, int V>
void launch_regs(const T* x, const float* scale, T* out, long long rows,
                 int d, float eps, int lanes, cudaStream_t stream) {
  // Enough warps for every row once, at most 8 blocks an SM: the rest of the
  // rows are walked by the grid-stride loop.
  const long long per_block = static_cast<long long>(kWarps) * (32 / lanes);
  const long long need = (rows + per_block - 1) / per_block;
  const long long cap = 8LL * sm_count();
  const dim3 grid(static_cast<unsigned>(need < cap ? need : cap));
  rmsnorm_regs<T, V><<<grid, kWarps * 32, 0, stream>>>(x, scale, out, rows,
                                                        d, eps, lanes);
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows,
           int d, float eps, int vec, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const Geometry g = geometry(d, sizeof(T), vec);
  if (g.path == 2) {
    switch (g.vecs) {
      case 1:
        launch_regs<T, 1>(xt, scale, ot, rows, d, eps, g.lanes_per_row, stream);
        break;
      case 2:
        launch_regs<T, 2>(xt, scale, ot, rows, d, eps, g.lanes_per_row, stream);
        break;
      default:
        launch_regs<T, 4>(xt, scale, ot, rows, d, eps, g.lanes_per_row, stream);
        break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (g.path == 1) {
    rmsnorm_loop<T, true><<<grid, kWarps * 32, 0, stream>>>(xt, scale, ot,
                                                            rows, d, eps);
  } else {
    rmsnorm_loop<T, false><<<grid, kWarps * 32, 0, stream>>>(xt, scale, ot,
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

// The layout a call would take: out[0] = path (0 element by element, 1 loop,
// 2 registers), out[1] = lanes per row, out[2] = vectors a lane.
extern "C" void pollen_rmsnorm_geometry(int d, int dtype, int vec, int* out) {
  const Geometry g = geometry(d, dtype == 0 ? 4 : 2, vec);
  out[0] = g.path;
  out[1] = g.lanes_per_row;
  out[2] = g.vecs;
}

extern "C" const char* pollen_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
