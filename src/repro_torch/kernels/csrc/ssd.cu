// K5: Mamba-2's chunked SSD (state-space duality), hand-written for Hopper as
// a plain SIMT kernel.  For one (batch, head) and its B/C group
// g = h / (H / G), with A = -exp(A_log[h]) and a [p, n] f32 state carried
// from chunk to chunk (zero before the first), per chunk of Q rows:
//
//     la[i]   = sum_{j <= i} dt[j] A                     (decay prefix)
//     L[i][j] = (C[i] . B[j]) exp(la[i] - la[j])          for j <= i, else 0
//     y[i]    = sum_j L[i][j] dt[j] x[j]
//               + exp(la[i]) (state . C[i]) + D x[i]
//     state   = exp(la[Q-1]) state
//               + sum_j exp(la[Q-1] - la[j]) dt[j] x[j] (x) B[j]
//
// Rows at or past the true length s count as zeros (dt = 0 changes nothing
// before them), which is the TPU wrapper's zero padding of s to a chunk
// multiple (repro/kernels/ops.py:137 ssd).  Every la difference used is
// <= 0, so exp never overflows; a fully decayed term underflows to 0.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py:83 ssd_bhsp.  As
// there: f32 math on inputs of any of the two types, the output in x's
// type.  It also writes the carried final state, which the TPU path
// recomputes with a second, unfused pass (repro/models/ssd.py:246-248).
//
// Bound: at the serve shape (x [4, 2048, 80, 64] bf16, n 128, one group,
// Q 128) the function moves 185 MB (x and y 84 MB each, dt 2.6 MB, B and
// C 2.1 MB each, the state 10.5 MB) and needs 26.4 GFLOP (C B^T once per
// group, lower triangles only), so it is bound by bytes: 0.055 ms at
// 3.35 TB/s, the operations 0.027 ms at the bf16 tensor-core peak.  This
// first version runs SIMT f32 FMAs out of shared memory, not wgmma: right
// and simple first.  What it does:
//   * one block per (head, batch); inside it a loop over chunks takes the
//     place of the TPU's sequential grid axis, and the state never leaves
//     the chip: 256 threads as 16 x 16, each holding up to 4 x 8 entries of
//     the [p, n] state in registers;
//   * per chunk, C, B and x * dt are staged in shared memory as f32 (rows
//     padded by one float, so the 16 rows a half-warp reads at one column
//     fall in 16 banks); the state is staged once for C . state, and its
//     buffer then holds L;
//   * the model layout [b, s, h, p] and [b, s, g, n] is read through
//     strides: nothing is transposed or padded in memory;
//   * only the lower triangle of L is computed and used;
//   * shared memory is at most 231,936 bytes (Q 128, n 128, p 64), inside
//     the 232,448 a block may opt in to.
// Later (ROADMAP): the three products on wgmma from bf16 tiles, and more
// than one block per SM.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kT = 16;
constexpr int kMaxQ = 128, kMaxP = 64, kMaxN = 128;
constexpr int kRQ = kMaxQ / kT;  // chunk rows a thread owns (row groups)
constexpr int kRP = kMaxP / kT;  // head-dim columns a thread owns
constexpr int kRN = kMaxN / kT;  // state columns a thread owns

struct Strides {
  long long b, s, h;  // in elements; the last dim is contiguous
};

struct Dims {
  int s, q, p, n, hpg;  // true sizes; chunk q; heads per B/C group
  int qp, pp, np;       // q, p, n rounded up to multiples of 16
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

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

__host__ __device__ inline size_t smem_floats(int qp, int pp, int np) {
  const int w2 = qp * (qp + 1) > pp * (np + 1) ? qp * (qp + 1)
                                                : pp * (np + 1);
  return static_cast<size_t>(2) * qp * (np + 1)  // C, B
         + w2                                    // the state, then L
         + static_cast<size_t>(qp) * pp          // x * dt
         + 2 * qp;                               // la, then w
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a_log, const T* __restrict__ bm,
            const T* __restrict__ cm, const float* __restrict__ dsk,
            T* __restrict__ y, float* __restrict__ state_out, Strides xs,
            Strides ds, Strides bs, Strides cs, Dims d) {
  extern __shared__ float smem[];
  const int ldn = d.np + 1, ldq = d.qp + 1;
  float* Cs = smem;                                     // [qp][np + 1]
  float* Bs = Cs + d.qp * ldn;                          // [qp][np + 1]
  float* W2 = Bs + d.qp * ldn;                          // S or L
  const int w2 = d.qp * ldq > d.pp * ldn ? d.qp * ldq : d.pp * ldn;
  float* Xs = W2 + w2;                                  // [qp][pp]
  float* la = Xs + d.qp * d.pp;                         // [qp]
  float* wv = la + d.qp;                                // dt, then w

  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const int h = blockIdx.x;
  const long long bi = blockIdx.y;
  const int hg = h / d.hpg;
  const int nq = d.qp / kT, npg = d.pp / kT, nng = d.np / kT;
  const int H = gridDim.x;
  const float A = -expf(a_log[h]);
  const float Dh = dsk[h];

  const T* xb = x + bi * xs.b + h * xs.h;
  const float* db = dt + bi * ds.b + h * ds.h;
  const T* bb = bm + bi * bs.b + hg * bs.h;
  const T* cb = cm + bi * cs.b + hg * cs.h;
  T* yb = y + (bi * d.s * H + h) * static_cast<long long>(d.p);

  float st[kRP][kRN];  // state[ty + 16a][tx + 16c]
#pragma unroll
  for (int a = 0; a < kRP; ++a) {
#pragma unroll
    for (int c = 0; c < kRN; ++c) st[a][c] = 0.0f;
  }

  for (int t0 = 0; t0 < d.s; t0 += d.q) {
    const int rows = min(d.q, d.s - t0);  // valid rows of this chunk
    // (a) dt, C, B and the state into shared memory.
    for (int j = tid; j < d.qp; j += kThreads) {
      wv[j] = j < rows ? db[static_cast<long long>(t0 + j) * ds.s] : 0.0f;
    }
    for (int e = tid; e < d.qp * d.np; e += kThreads) {
      const int j = e / d.np, k = e % d.np;
      const bool in = j < rows && k < d.n;
      const long long r = t0 + j;
      Cs[j * ldn + k] = in ? to_f32(cb[r * cs.s + k]) : 0.0f;
      Bs[j * ldn + k] = in ? to_f32(bb[r * bs.s + k]) : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kRP; ++a) {
#pragma unroll
      for (int c = 0; c < kRN; ++c) {
        if (a < npg && c < nng) {
          W2[(ty + kT * a) * ldn + tx + kT * c] = st[a][c];
        }
      }
    }
    __syncthreads();

    // (b) x * dt; warp 0 scans la = cumsum(dt * A).
    for (int e = tid; e < d.qp * d.pp; e += kThreads) {
      const int j = e / d.pp, c = e % d.pp;
      const bool in = j < rows && c < d.p;
      Xs[e] = in ? to_f32(xb[static_cast<long long>(t0 + j) * xs.s + c]) *
                       wv[j]
                 : 0.0f;
    }
    if (tid < 32) {
      const int per = (d.qp + 31) / 32;  // <= 4 consecutive rows a lane
      float loc[4];
      float run = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tid * per + u;
        if (u < per && j < d.qp) run += wv[j] * A;
        loc[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tid * per + u;
        if (u < per && j < d.qp) la[j] = excl + loc[u];
      }
    }
    __syncthreads();

    // (c) y = exp(la) (C . state^T).
    const float la_last = la[d.qp - 1];
    float acc[kRQ][kRP];  // y[ty + 16r][tx + 16c]
#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
#pragma unroll
      for (int c = 0; c < kRP; ++c) acc[r][c] = 0.0f;
    }
    if (t0 > 0) {  // the state is zero before the first chunk
      for (int k = 0; k < d.np; ++k) {
        float cv[kRQ], sv[kRP];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) {
          cv[r] = r < nq ? Cs[(ty + kT * r) * ldn + k] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kRP; ++c) {
          sv[c] = c < npg ? W2[(tx + kT * c) * ldn + k] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRQ; ++r) {
#pragma unroll
          for (int c = 0; c < kRP; ++c) {
            acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        const float e = r < nq ? expf(la[ty + kT * r]) : 0.0f;
#pragma unroll
        for (int c = 0; c < kRP; ++c) acc[r][c] *= e;
      }
    }
    __syncthreads();  // the state's and dt's last reads are done
    for (int j = tid; j < d.qp; j += kThreads) {
      wv[j] = expf(la_last - la[j]);  // the state update's decay
    }

    // (d) L[i][j] for j <= i into W2.
    {
      float lc[kRQ][kRQ];  // L[ty + 16r][tx + 16c]; only c <= r is used
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
#pragma unroll
        for (int c = 0; c <= r; ++c) lc[r][c] = 0.0f;
      }
      for (int k = 0; k < d.np; ++k) {
        float cv[kRQ], bv[kRQ];
#pragma unroll
        for (int r = 0; r < kRQ; ++r) {
          cv[r] = r < nq ? Cs[(ty + kT * r) * ldn + k] : 0.0f;
          bv[r] = r < nq ? Bs[(tx + kT * r) * ldn + k] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRQ; ++r) {
#pragma unroll
          for (int c = 0; c <= r; ++c) {
            lc[r][c] = fmaf(cv[r], bv[c], lc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRQ; ++r) {
        if (r < nq) {
          const int i = ty + kT * r;
          const float lai = la[i];
#pragma unroll
          for (int c = 0; c <= r; ++c) {
            const int j = tx + kT * c;
            W2[i * ldq + j] = j <= i ? lc[r][c] * expf(lai - la[j]) : 0.0f;
          }
        }
      }
    }
    __syncthreads();

    // (e) y += L (x dt), then + D x, for the valid rows.  Row group r
    // reads keys j < 16 (r + 1) only: the rest of its L row is zero.
    for (int jb = 0; jb < nq; ++jb) {
      for (int jj = 0; jj < kT; ++jj) {
        const int j = kT * jb + jj;
        float xv[kRP];
#pragma unroll
        for (int c = 0; c < kRP; ++c) {
          xv[c] = c < npg ? Xs[j * d.pp + tx + kT * c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRQ; ++r) {
          if (r >= jb && r < nq) {
            const float l = W2[(ty + kT * r) * ldq + j];
#pragma unroll
            for (int c = 0; c < kRP; ++c) {
              acc[r][c] = fmaf(l, xv[c], acc[r][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int i = ty + kT * r;
      if (r < nq && i < rows) {
        const long long t = t0 + i;
#pragma unroll
        for (int c = 0; c < kRP; ++c) {
          const int col = tx + kT * c;
          if (c < npg && col < d.p) {
            const float xi = to_f32(xb[t * xs.s + col]);
            yb[t * H * d.p + col] = from_f32<T>(acc[r][c] + Dh * xi);
          }
        }
      }
    }

    // (f) state = exp(la_last) state
    //             + sum_j (exp(la_last - la[j]) x[j] dt[j]) (x) B[j].
    const float dec = expf(la_last);
#pragma unroll
    for (int a = 0; a < kRP; ++a) {
#pragma unroll
      for (int c = 0; c < kRN; ++c) st[a][c] *= dec;
    }
    for (int j = 0; j < rows; ++j) {
      const float w = wv[j];
      float xv[kRP], bv[kRN];
#pragma unroll
      for (int a = 0; a < kRP; ++a) {
        xv[a] = a < npg ? w * Xs[j * d.pp + ty + kT * a] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kRN; ++c) {
        bv[c] = c < nng ? Bs[j * ldn + tx + kT * c] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < kRP; ++a) {
#pragma unroll
        for (int c = 0; c < kRN; ++c) st[a][c] = fmaf(xv[a], bv[c], st[a][c]);
      }
    }
    __syncthreads();  // the next chunk overwrites every buffer
  }

  if (state_out != nullptr) {  // [b, h, p, n] f32
    float* so = state_out + (bi * H + h) * static_cast<long long>(d.p) * d.n;
#pragma unroll
    for (int a = 0; a < kRP; ++a) {
      const int pr = ty + kT * a;
#pragma unroll
      for (int c = 0; c < kRN; ++c) {
        const int nc = tx + kT * c;
        if (a < npg && c < nng && pr < d.p && nc < d.n) {
          so[static_cast<long long>(pr) * d.n + nc] = st[a][c];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* dsk, void* y, void* state_out,
           Strides xs, Strides ds, Strides bs, Strides cs, Dims d, int batch,
           int heads, cudaStream_t stream) {
  const size_t smem = smem_floats(d.qp, d.pp, d.np) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  ssd_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(dsk),
      static_cast<T*>(y), static_cast<float*>(state_out), xs, ds, bs, cs, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [b, s, h, p] and B, C: [b, s, g, n] in one type (0 = f32, 1 = bf16),
// dt: [b, s, h] f32, each addressed through its (batch, seq, head-or-group)
// strides in elements with the last dim contiguous; A_log, D: [h] f32,
// contiguous.  y: a contiguous [b, s, h, p] of x's type; state_out: a
// contiguous [b, h, p, n] f32, or null.  h a multiple of g; p <= 64,
// n <= 128, chunk <= 128.  Returns cudaGetLastError().
extern "C" int pollen_ssd(const void* x, const void* dt, const void* a_log,
                          const void* b, const void* c, const void* dsk,
                          void* y, void* state_out, long long x_sb,
                          long long x_ss, long long x_sh, long long dt_sb,
                          long long dt_ss, long long dt_sh, long long b_sb,
                          long long b_ss, long long b_sg, long long c_sb,
                          long long c_ss, long long c_sg, int batch, int s,
                          int h, int g, int p, int n, int chunk, int dtype,
                          void* stream) {
  if (batch <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (h <= 0 || g <= 0 || h % g != 0 || p <= 0 || p > kMaxP || n <= 0 ||
      n > kMaxN || chunk <= 0 || chunk > kMaxQ || batch > 65535 ||
      h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides xs{x_sb, x_ss, x_sh}, ds{dt_sb, dt_ss, dt_sh},
      bs{b_sb, b_ss, b_sg}, cs{c_sb, c_ss, c_sg};
  const Dims d{s, chunk, p, n, h / g, round16(chunk), round16(p), round16(n)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, a_log, b, c, dsk, y, state_out, xs, ds, bs,
                         cs, d, batch, h, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, dsk, y, state_out, xs,
                                 ds, bs, cs, d, batch, h, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* pollen_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
