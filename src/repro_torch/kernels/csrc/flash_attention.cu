// K4: blockwise online-softmax attention (GQA, causal or not), hand-written
// for Hopper as a plain SIMT kernel.  For query row i of head h:
//
//     out[i] = sum_j softmax_j(q_i . k_j / sqrt(d)) v_j,
//              j over keys with j < t_pad and, when causal, j <= i
//
// with kv head h / (hq / hkv).  Keys in [t, t_pad) are zero vectors: that is
// the TPU wrapper's zero padding of t to a block multiple, which a causal
// query i >= t would see (repro/kernels/ops.py:110 flash_attention).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:89
// flash_attention_bhsd.  As there: f32 scores, running max m, sum l and
// accumulator in f32, masked scores at -1e30, whole key tiles above the
// diagonal skipped, and the final division guarded by l > 0.
//
// Bound: at the serve shape (b 4, s 2048, 16 q / 8 kv heads, d 128, bf16,
// causal) the work is 68.7 GFLOP against 100.7 MB of q, k, v and out, so it
// is bound by operations (0.069 ms at the bf16 tensor-core peak; the bytes
// take 0.030 ms).  This first version is SIMT f32 FMAs, not wgmma: right
// and simple first.  What it does about the bound:
//   * one block per (q tile of 64 rows, q head, batch), the tiles with the
//     most causal work launched first; it reads the [b, s, h, d] model
//     layout through strides, so nothing is transposed or padded in memory;
//   * the 64-row q tile stays in shared memory as f32; each 64-key tile of
//     k and v is staged once in shared memory and reused by all 64 rows;
//   * 256 threads as 16 x 16: a thread owns 4 rows x 4 keys of the score
//     tile (16 FMAs per 8 shared loads) and 4 rows x d/16 columns of the
//     accumulator (registers); a row's max and sum are reduced across its
//     16 threads with xor shuffles inside one half-warp;
//   * rows padded by one float in shared memory, so the 16 keys a half-warp
//     reads at one column fall in 16 different banks;
//   * no key tile beyond the diagonal is loaded or computed.
// Later (ROADMAP): wgmma on bf16 tiles from TMA, warp-specialised.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTX = 16;
constexpr int kRows = kBQ / 16;  // rows a thread owns
constexpr int kKeys = kBK / 16;  // keys a thread scores per tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

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
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        Strides qs, Strides ks, Strides vs, int s, int t,
                        int t_pad, int hq, int hkv, int causal, float scale) {
  constexpr int NC = D / kTX;  // accumulator columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);   // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);   // [kBK][D]
  float* Ps = Vs + kBK * D;         // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kh = h / (hq / hkv);

  const T* qb = q + bi * qs.b + h * qs.h;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, i = q0 + r;
    Qs[r * (D + 1) + c] =
        i < s ? to_f32(qb[static_cast<long long>(i) * qs.s + c]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const T* kb = k + bi * ks.b + kh * ks.h;
  const T* vb = v + bi * vs.b + kh * vs.h;
  const int k_end = causal ? min(q0 + kBQ, t_pad) : t_pad;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q is staged; the last tile's P.V is done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, j = k0 + r;
      const bool in = j < t;
      Ks[r * (D + 1) + c] =
          in ? to_f32(kb[static_cast<long long>(j) * ks.s + c]) : 0.0f;
      Vs[r * D + c] =
          in ? to_f32(vb[static_cast<long long>(j) * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + kTX * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = Ks[(tx + kTX * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTX * i;
      bool valid[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + kTX * j;
        valid[j] = key < t_pad && (!causal || key <= row);
        sc[i][j] = valid[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = valid[j] ? __expf(sc[i][j] - m_new) : 0.0f;
        Ps[(ty + kTX * i) * (kBK + 1) + tx + kTX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + kTX * i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * D + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

  // out: [b, s, hq, D], contiguous
  T* ob = out + (bi * s * hq + h) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTX * i;
    if (row >= s) continue;
    const float denom = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ob[static_cast<long long>(row) * hq * D + tx + kTX * c] =
          from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs,
           Strides ks, Strides vs, int b, int s, int t, int t_pad, int hq,
           int hkv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();  // 115,456 bytes at d = 128
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, hq, b);
  flash_attention_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, s, t, t_pad,
      hq, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               Strides qs, Strides ks, Strides vs, int b, int s, int t,
               int t_pad, int hq, int hkv, int causal, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq, hkv,
                           causal, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq, hkv,
                           causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq, hkv,
                           causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq,
                            hkv, causal, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [b, s, hq, d], k and v: [b, t, hkv, d], each addressed through its
// (batch, seq, head) strides in elements with the head dim contiguous; out:
// a contiguous [b, s, hq, d].  dtype 0 = f32, 1 = bf16 (all four alike);
// d in {16, 32, 64, 128}; hq a multiple of hkv; t <= t_pad.  Returns
// cudaGetLastError().
extern "C" int pollen_flash_attention(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int b,
    int s, int t, int t_pad, int hq, int hkv, int d, int causal, int dtype,
    float scale, void* stream) {
  if (b <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (t <= 0 || t_pad < t || hkv <= 0 || hq % hkv != 0 || b > 65535 ||
      hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq,
                             hkv, causal, scale, st);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, qs, ks, vs, b, s, t,
                                     t_pad, hq, hkv, causal, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pollen_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
