// K5: Mamba-2's chunked SSD (state-space duality), hand-written for Hopper.
// For one (batch, head) and its B/C group
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
// there: f32 sums on inputs of either type, the output in x's type.  It
// also writes the carried final state, which the TPU path recomputes with a
// second, unfused pass (repro/models/ssd.py:246-248).
//
// Bound: at the serve shape (x [4, 2048, 80, 64] bf16, n 128, one group,
// Q 128) the function moves 185 MB (x and y 84 MB each, dt 2.6 MB, B and
// C 2.1 MB each, the state 10.5 MB) and needs 26.4 GFLOP (C B^T once per
// group, lower triangles only), so it is bound by bytes: 0.055 ms at
// 3.35 TB/s, the operations 0.027 ms at the bf16 tensor-core peak.  f32
// FMAs alone could not go below ~0.6 ms, so bf16 takes the tensor cores.
// Two routes, chosen by dtype and widths:
//
// * bf16 at p = 64 with n a multiple of 8 (any chunk): the wgmma kernel
//   (namespace wg).
//   - One block per (head, batch) with two warpgroups, a loop over chunks,
//     the [64, n] f32 state in warpgroup 0's registers between chunks: it
//     never leaves the chip.  Not split over p: at p = 64 every operand is
//     one of the two 128-byte-swizzled layouts K4 reads (K-major for C B^T
//     and C S^T, MN-major for x and B), the state update's M = p fills a
//     wgmma, and a p-split would recompute C B^T per slice.
//   - A chunk is padded to 128 rows with zeros, n to 64 or 128 columns.
//     Warpgroup w takes rows 64 w .. 64 w + 63 and makes w + 1 passes over
//     64 keys each (the causal triangle needs no more); warpgroup 0 also
//     runs the state update, so the two carry about the same work.
//   - Per chunk: C S^T (the state's bf16 pair) and C B^T by wgmma from
//     shared memory, f32 accumulators; W = C B^T exp(la_i - la_j) dt_j in
//     registers, as CB 2^(la_i log2 e + lg_j) with lg_j = log2 dt_j -
//     la_j log2 e from warp 0's scan (one exp2 a key); y += W x with W's
//     bf16 pair re-packed in place as register A fragments (K4's P V
//     layout match), x MN-major; the state update as (V_hi + V_lo)^T B,
//     V = exp(la_last - la_j) dt_j x_j built as A fragments, B MN-major.
//   - Numerics: every f32 operand of a product (W, the state, V) goes in as
//     a hi + lo pair of bf16 values, two wgmmas into one f32 accumulator:
//     one bf16 rounding of V puts the final state past its 1e-4, one of W
//     or of the state (in C S^T) puts y past its bf16 tolerance
//     (tests/test_torch_ssd.py emulates this route's rounding step by step
//     on the CPU, and pins each of those three).
//   - C, B and x arrive by TMA over 4-d tensor maps with the caller's
//     strides (the model layout is read in place), 64 x 128 boxes into a
//     two-stage ring guarded by mbarriers: chunk c + 1's tiles load while
//     chunk c computes.  Rows past the tensor's end and columns past n are
//     TMA's zero fill; the rows of the next chunk that a chunk shorter than
//     128 rows lets in carry dt = 0 (dt comes by cp.async, zero-filled), so
//     their W and V are 0.  200,208 bytes of shared memory at n = 128.
// * f32 (wgmma would be TF32, which cannot hold f32's 1e-4), and bf16 at
//   other widths: the SIMT kernel (namespace simt), f32 FMAs:
//   - one block per (head, batch); inside it a loop over chunks takes the
//     place of the TPU's sequential grid axis, and the state never leaves
//     the chip: 256 threads as 16 x 16, each holding up to 4 x 8 entries of
//     the [p, n] state in registers;
//   - per chunk, C, B and x * dt are staged in shared memory as f32 (rows
//     padded by one float, so the 16 rows a half-warp reads at one column
//     fall in 16 banks); the state is staged once for C . state, and its
//     buffer then holds L;
//   - the model layout [b, s, h, p] and [b, s, g, n] is read through
//     strides: nothing is transposed or padded in memory;
//   - only the lower triangle of L is computed and used;
//   - shared memory is at most 231,936 bytes (Q 128, n 128, p 64), inside
//     the 232,448 a block may opt in to.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() (or cudaErrorInvalidValue where a tensor map cannot be
// built) so a refused launch surfaces in the caller.

#include "hopper.cuh"

namespace {

constexpr int kMaxQ = 128, kMaxP = 64, kMaxN = 128;

struct Dims {
  int s, q, p, n, hpg;  // true sizes; chunk q; heads per B/C group
  int qp, pp, np;       // q, p, n rounded up to multiples of 16
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

namespace simt {


constexpr int kThreads = 256;  // 16 x 16
constexpr int kT = 16;
constexpr int kRQ = kMaxQ / kT;  // chunk rows a thread owns (row groups)
constexpr int kRP = kMaxP / kT;  // head-dim columns a thread owns
constexpr int kRN = kMaxN / kT;  // state columns a thread owns

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

}  // namespace simt

namespace wg {

constexpr int kQ = 128;         // chunk rows, a shorter chunk zero-padded
constexpr int kP = 64;          // head dim
constexpr int kThreads = 256;   // two warpgroups
constexpr int kRow = 128;       // bytes in a row of a 64-column box
constexpr int kBoxQ = kQ * kRow;  // a 64-column box of a 128-row tile
constexpr int kBoxP = kP * kRow;  // a 64-column box of a 64-row tile

// Shared memory, 1024-byte aligned tiles (the 128-byte swizzle repeats
// every 1024 bytes): two stages of the chunk ring, each C and B (128 x NP
// bf16) and x (128 x 64 bf16); the state as hi and lo bf16 tiles (64 x
// NP); dt for both stages, la, the state update's weights and W's key
// factors (f32).
template <int NP>
struct Smem {
  static constexpr int kCB = kQ * NP * 2;           // C or B of one chunk
  static constexpr int kX = kQ * kP * 2;
  static constexpr int kStage = 2 * kCB + kX;
  static constexpr int kS = 2 * kStage;             // hi, then lo
  static constexpr int kSTile = kP * NP * 2;
  static constexpr int kDt = kS + 2 * kSTile;       // [2][kQ] f32
  static constexpr int kLa = kDt + 2 * kQ * 4;      // [kQ] f32
  static constexpr int kW = kLa + kQ * 4;           // [kQ] f32
  static constexpr int kLg = kW + kQ * 4;           // [kQ] f32
  static constexpr int kBar = kLg + kQ * 4;         // 2 mbarriers
  static constexpr int kBytes = kBar + 2 * 8 + 1024;  // + alignment slack
};

// Byte offset of element (r, col) of a bf16 tile of `rows` rows, stored as
// 64-column boxes of 128-byte rows with the 128-byte swizzle (the 16-byte
// piece k of row r sits at piece k ^ (r % 8)): the layout TMA writes and
// wgmma reads with swizzle mode 1.
__device__ __forceinline__ uint32_t swz(int r, int col, int rows) {
  return (col >> 6) * rows * kRow + r * kRow +
         ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

// 4 bytes from global to shared memory, asynchronously; src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (st.shared) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major operand rows (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major operand: 16-row steps of K are 16 x 128 bytes apart, 64-column
// boxes of a 128-row tile kBoxQ apart.
__device__ __forceinline__ uint64_t mn_major(uint32_t addr) {
  return smem_desc(addr, kBoxQ, 1024);
}

// f0, f1 as a hi + lo pair of bf16 pairs: hi = bf16(f), lo = bf16(f - hi),
// so hi + lo carries ~16 of f's 24 bits.
__device__ __forceinline__ void split_bf16(float f0, float f1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(f0 - __low2float(h), f1 - __high2float(h));
}

// Chunk t0 into ring stage `stage`, issued by one thread: C and B (128
// rows x NP columns, NP / 64 boxes each) and x (128 x 64) by TMA onto the
// stage's barrier.  Rows past the tensor's end and columns past n read as
// zeros; rows of the next chunk that a chunk shorter than 128 rows lets in
// are multiplied by their dt of 0 (load_dt), so they change nothing.
template <int NP>
__device__ __forceinline__ void load_tiles(uint32_t stage, uint32_t bar,
                                           const CUtensorMap* cmap,
                                           const CUtensorMap* bmap,
                                           const CUtensorMap* xmap, int h,
                                           int hg, int t0, int bi) {
  using L = Smem<NP>;
  mbar_expect_tx(bar, 2 * L::kCB + L::kX);
#pragma unroll
  for (int f = 0; f < NP / 64; ++f) {
    tma_load(stage + f * kBoxQ, cmap, bar, 64 * f, hg, t0, bi);
    tma_load(stage + L::kCB + f * kBoxQ, bmap, bar, 64 * f, hg, t0, bi);
  }
  tma_load(stage + 2 * L::kCB, xmap, bar, 0, h, t0, bi);
}

// dt of chunk t0 (its first `rows` rows valid, the rest 0) into dt_dst, by
// cp.async, one f32 a thread.
__device__ __forceinline__ void load_dt(uint32_t dt_dst, const float* db,
                                        long long ds_s, int t0, int rows) {
  const int r = threadIdx.x;
  if (r < kQ) {
    const bool in = r < rows;
    cp_async4(dt_dst + 4 * r, in ? db + (t0 + r) * ds_s : db, in ? 4u : 0u);
  }
}

// One warpgroup's 64 rows i of a chunk (rows 64 wg ..), in passes over 64
// keys j each (pass k: keys 64 k .., up to the causal diagonal: warpgroup
// wg makes wg + 1 passes, and only the last one holds keys past a row):
//   y     = exp(la_i) C (S_hi + S_lo)^T       (wgmma, the state's bf16 pair)
//   CB    = C B^T                             (wgmma, K-major both)
//   W     = CB exp(la_i - la_j) dt_j, j <= i  (f32, in registers, as
//           CB 2^(la_i log2 e + lg_j) with lg_j = log2 dt_j - la_j log2 e:
//           one exp2 a key; the padded rows' dt of 0 gives 0)
//   y    += (W_hi + W_lo) x                   (wgmma, W's bf16 pair as A
//                                              fragments, x MN-major)
// then y += D x, stored for the valid rows.  64 keys a pass keep CB and W
// at 32 registers each: with all 128 keys at once ptxas spilled.
template <int NP>
__device__ __forceinline__ void chunk_rows(
    uint32_t stage, uint32_t s_hi, const uint8_t* gx, const float* la,
    const float* lg, bool has_state, float Dh, __nv_bfloat16* yrow0,
    long long y_row_stride, int rows, int wg, int warp, int lane) {
  using L = Smem<NP>;
  const uint32_t c_rows = stage + wg * 64 * kRow;
  const uint32_t b_tile = stage + L::kCB;
  const uint32_t x_tile = stage + 2 * L::kCB;
  const uint32_t s_lo = s_hi + L::kSTile;

  float y[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = 0.0f;
  if (has_state) {
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxQ + (kk % 4) * 32;
      const uint32_t soff = (kk / 4) * kBoxP + (kk % 4) * 32;
      wgmma_ss_n64(y, k_major(c_rows + off), k_major(s_hi + soff), 1);
      wgmma_ss_n64(y, k_major(c_rows + off), k_major(s_lo + soff), 1);
    }
    wgmma_commit();
  }

  // Accumulator fragment of wgmma m64nNk16 (f32): register 4 jb + 2 r + e
  // holds row 16 warp + lane / 4 + 8 r, column 8 jb + 2 (lane % 4) + e.
  const int i0 = wg * 64 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float la_i[2], la2_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    la_i[r] = la[i0 + 8 * r];
    la2_i[r] = la_i[r] * kLog2e;
  }

  for (int pass = 0; pass <= wg; ++pass) {
    float cb[32];
    fence_regs(cb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxQ + (kk % 4) * 32;
      wgmma_ss_n64(cb, k_major(c_rows + off),
                   k_major(b_tile + pass * 64 * kRow + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();  // CB, and in the first pass C S^T
    fence_regs(cb);
    fence_regs(y);
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e = expf(la_i[r]);
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          y[4 * jb + 2 * r] *= e;
          y[4 * jb + 2 * r + 1] *= e;
        }
      }
    }
    const bool diagonal = pass == wg;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = pass * 64 + 8 * jb + c0 + e;
        const float lg_j = lg[j];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& v = cb[4 * jb + 2 * r + e];
          v = !diagonal || j <= i0 + 8 * r ? v * ex2(la2_i[r] + lg_j) : 0.0f;
        }
      }
    }
    // W as bf16 A fragments: keys 16 kk .. 16 kk + 15 of the pass are the
    // accumulator's column blocks 2 kk and 2 kk + 1, already in the A
    // operand's layout.
    uint32_t w_hi[4][4], w_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split_bf16(cb[8 * kk + 2 * q], cb[8 * kk + 2 * q + 1], w_hi[kk][q],
                   w_lo[kk][q]);
      }
    }
    fence_regs(w_hi);
    fence_regs(w_lo);
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t xd = mn_major(x_tile + (pass * 64 + kk * 16) * kRow);
      wgmma_rs_n64(y, w_hi[kk], xd);
      wgmma_rs_n64(y, w_lo[kk], xd);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
  }

  const uint8_t* xs = gx + 2 * L::kCB;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= rows) continue;
    __nv_bfloat16* yr = yrow0 + i * y_row_stride;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int col = 8 * jb + c0;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(xs + swz(i, col, kQ));
      *reinterpret_cast<__nv_bfloat162*>(yr + col) = __floats2bfloat162_rn(
          y[4 * jb + 2 * r] + Dh * __low2float(xv),
          y[4 * jb + 2 * r + 1] + Dh * __high2float(xv));
    }
  }
}

// One block per (head, batch), two warpgroups, a loop over chunks; the
// [64, n] f32 state lives in warpgroup 0's registers, and as a bf16 hi + lo
// pair in shared memory for the next chunk's C S^T.
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_fwd_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ CUtensorMap cmap,
                  const float* __restrict__ dt,
                  const float* __restrict__ a_log,
                  const float* __restrict__ dsk, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ state_out, Strides ds, Dims d) {
  using L = Smem<NP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* dts = reinterpret_cast<float*>(gbase + L::kDt);  // [2][kQ]
  float* la = reinterpret_cast<float*>(gbase + L::kLa);
  float* wv = reinterpret_cast<float*>(gbase + L::kW);
  float* lg = reinterpret_cast<float*>(gbase + L::kLg);
  const uint32_t s_hi = base + L::kS;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.x;
  const long long bi = blockIdx.y;
  const int H = gridDim.x;
  const int hg = h / d.hpg;
  const float A = -expf(a_log[h]);
  const float Dh = dsk[h];
  const float* db = dt + bi * ds.b + h * ds.h;
  const long long y_row = static_cast<long long>(H) * kP;
  __nv_bfloat16* yb = y + (bi * d.s * H + h) * kP;
  // Warpgroup 0 carries the state (its rows need one pass of keys,
  // warpgroup 1's two): NP / 64 fragments of 64 columns, register 4 jb +
  // 2 r + e of fragment f holding p = 16 warp + lane / 4 + 8 r, n = 64 f +
  // 8 jb + 2 (lane % 4) + e.
  constexpr int kF = NP / 64;
  const bool carries = wg == 0;
  float st[kF][32];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) st[f][i] = 0.0f;
  }

  const uint32_t bar = base + L::kBar;  // one full barrier a stage
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (d.s + d.q - 1) / d.q;
  if (tid == 0) load_tiles<NP>(base, bar, &cmap, &bmap, &xmap, h, hg, 0, bi);
  load_dt(smem_u32(dts), db, ds.s, 0, min(d.q, d.s));
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int si = c & 1;
    const int t0 = c * d.q;
    const int rows = min(d.q, d.s - t0);
    const uint32_t stage = base + si * L::kStage;
    const uint8_t* gstage = gbase + si * L::kStage;
    const float* dtc = dts + si * kQ;
    // The next chunk's copies go out before this chunk's wait: the ring's
    // other stage was last read before the barrier that closed chunk c-1.
    if (c + 1 < n_chunks) {
      if (tid == 0) {
        load_tiles<NP>(base + (si ^ 1) * L::kStage, bar + 8 * (si ^ 1), &cmap,
                       &bmap, &xmap, h, hg, t0 + d.q, bi);
      }
      load_dt(smem_u32(dts + (si ^ 1) * kQ), db, ds.s, t0 + d.q,
              min(d.q, d.s - t0 - d.q));
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's dt copy of this chunk has landed
    mbar_wait(bar + 8 * si, (c >> 1) & 1);  // this chunk's tiles have
    __syncthreads();

    // Warp 0: la = cumsum(dt A) over the 128 rows (4 consecutive a lane),
    // the state update's weights w_j = exp(la_last - la_j) dt_j and W's
    // key factors lg_j = log2 dt_j - la_j log2 e.
    if (tid < 32) {
      float loc[4];
      float run = 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        run += dtc[4 * tid + u] * A;
        loc[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float la_last = __shfl_sync(0xffffffffu, incl, 31);
      const float excl = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * tid + u;
        la[j] = excl + loc[u];
        wv[j] = expf(la_last - (excl + loc[u])) * dtc[j];
        lg[j] = __log2f(dtc[j]) - (excl + loc[u]) * kLog2e;
      }
    }
    __syncthreads();

    chunk_rows<NP>(stage, s_hi, gstage, la, lg, c > 0, Dh, yb + t0 * y_row,
                   y_row, rows, wg, warp, lane);

    // state = exp(la_last) state + (V_hi + V_lo)^T B, V[j][p] = w_j x[j][p]
    // as bf16 A fragments (rows p, keys j), B MN-major: wgmma m64n64 for
    // each 64 columns of n, all from the same V fragments.
    if (carries) {
      const float dec = expf(la[kQ - 1]);
#pragma unroll
      for (int f = 0; f < kF; ++f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) st[f][i] *= dec;
      }
      const uint8_t* gx = gstage + 2 * L::kCB;
      const int p0 = warp * 16 + lane / 4;
      const int j0 = 2 * (lane % 4);
      uint32_t v_hi[8][4], v_lo[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + 8 * (q & 1);
          const int j = 16 * kk + j0 + 8 * (q >> 1);
          const float f0 = wv[j] * __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(gx + swz(j, p, kQ)));
          const float f1 = wv[j + 1] * __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(gx + swz(j + 1, p, kQ)));
          split_bf16(f0, f1, v_hi[kk][q], v_lo[kk][q]);
        }
      }
      fence_regs(v_hi);
      fence_regs(v_lo);
#pragma unroll
      for (int f = 0; f < kF; ++f) fence_regs(st[f]);
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const uint32_t b_cols = stage + L::kCB + f * kBoxQ;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t bd = mn_major(b_cols + kk * 16 * kRow);
          wgmma_rs_n64(st[f], v_hi[kk], bd);
          wgmma_rs_n64(st[f], v_lo[kk], bd);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int f = 0; f < kF; ++f) fence_regs(st[f]);
    }
    __syncthreads();  // every read of this stage and of the state tiles done

    if (carries && c + 1 < n_chunks) {
      uint8_t* shi = gbase + L::kS;
      uint8_t* slo = shi + L::kSTile;
#pragma unroll
      for (int f = 0; f < kF; ++f) {
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = warp * 16 + lane / 4 + 8 * r;
            const int n = f * 64 + 8 * jb + 2 * (lane % 4);
            uint32_t hi, lo;
            split_bf16(st[f][4 * jb + 2 * r], st[f][4 * jb + 2 * r + 1], hi,
                       lo);
            const uint32_t off = swz(p, n, kP);
            *reinterpret_cast<uint32_t*>(shi + off) = hi;
            *reinterpret_cast<uint32_t*>(slo + off) = lo;
          }
        }
      }
      fence_proxy_async();
    }
  }

  if (state_out != nullptr && carries) {  // [b, h, 64, n] f32
    float* so = state_out + (bi * H + h) * static_cast<long long>(kP) * d.n;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = warp * 16 + lane / 4 + 8 * r;
          const int n = f * 64 + 8 * jb + 2 * (lane % 4);
          if (n < d.n) {  // n is a multiple of 8, so n + 1 < d.n as well
            float* row = so + static_cast<long long>(p) * d.n + n;
            row[0] = st[f][4 * jb + 2 * r];
            row[1] = st[f][4 * jb + 2 * r + 1];
          }
        }
      }
    }
  }
}

template <int NP>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* dsk, void* y, void* state_out,
           Strides xs, Strides ds, Strides bs, Strides cs, Dims d, int batch,
           int heads, int groups, cudaStream_t stream) {
  CUtensorMap xmap, bmap, cmap;
  if (!encode(&xmap, x, xs, batch, d.s, heads, kP) ||
      !encode(&bmap, b, bs, batch, d.s, groups, d.n) ||
      !encode(&cmap, c, cs, batch, d.s, groups, d.n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Smem<NP>::kBytes;  // 200,208 bytes at n 128
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_wgmma<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, batch);
  ssd_fwd_wgmma<NP><<<grid, kThreads, smem, stream>>>(
      xmap, bmap, cmap, static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(dsk),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state_out), ds, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// The route a call takes, from its dtype and widths alone: 1 = wgmma (bf16
// at p = 64 with n a multiple of 8, any chunk), 0 = SIMT.
int route(int dtype, int p, int n) {
  return dtype == 1 && p == wg::kP && n % 8 == 0;
}

}  // namespace

// x: [b, s, h, p] and B, C: [b, s, g, n] in one type (0 = f32, 1 = bf16),
// dt: [b, s, h] f32, each addressed through its (batch, seq, head-or-group)
// strides in elements with the last dim contiguous; A_log, D: [h] f32,
// contiguous.  y: a contiguous [b, s, h, p] of x's type; state_out: a
// contiguous [b, h, p, n] f32, or null.  h a multiple of g; p <= 64,
// n <= 128, chunk <= 128.  On the wgmma route (bf16, p 64, n a multiple of
// 8) every base and stride of x, B and C must be a multiple of 16 bytes.
// Returns cudaGetLastError().
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
  if (route(dtype, p, n)) {
    return n > 64 ? wg::launch<128>(x, dt, a_log, b, c, dsk, y, state_out, xs,
                                    ds, bs, cs, d, batch, h, g, st)
                  : wg::launch<64>(x, dt, a_log, b, c, dsk, y, state_out, xs,
                                   ds, bs, cs, d, batch, h, g, st);
  }
  if (dtype == 0) {
    return simt::launch<float>(x, dt, a_log, b, c, dsk, y, state_out, xs, ds,
                               bs, cs, d, batch, h, st);
  }
  if (dtype == 1) {
    return simt::launch<__nv_bfloat16>(x, dt, a_log, b, c, dsk, y, state_out,
                                       xs, ds, bs, cs, d, batch, h, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 where a call of this dtype, head dim, state width and chunk takes the
// wgmma kernel, else 0 (the chunk does not change the route).
extern "C" int pollen_ssd_route(int dtype, int p, int n, int chunk) {
  (void)chunk;
  return route(dtype, p, n);
}

extern "C" const char* pollen_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
