// K4: blockwise online-softmax attention (GQA, causal or not), hand-written
// for Hopper.  For query row i of head h:
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
// is bound by operations: 0.069 ms at the bf16 tensor-core peak (the bytes
// take 0.030 ms).  Two routes, chosen by dtype and head dim:
//
// * bf16 at d = 64 and 128: the wgmma kernel (namespace wg).  The tensor
//   cores are the only way to the bound:
//   - one block per (128-row q tile, q head, batch), the q tile in grid z
//     so the tiles with the most causal work start first over all heads
//     and batches; 3 warpgroups: two consumers of 64 q rows each and a
//     producer whose first lane issues every copy (its other warps give
//     their registers away by setmaxnreg and leave);
//   - TMA over a 4-d tensor map (d, h, s, b) with the caller's strides, so
//     [b, s, h, d] is read in place; boxes of 64 d x 128 rows, 128-byte
//     swizzled; q is loaded once, k and v through a 2-stage ring of
//     128-key tiles guarded by mbarriers (full: the copy landed; empty: both
//     consumers are done), so the next tile's copy overlaps this tile's
//     products; the map covers t keys, and TMA's zero fill gives the keys
//     in [t, t_pad) as the zero vectors they are;
//   - per 64 keys (half a tile): S = Q K^T by wgmma m64n64k16 from shared
//     memory (both K-major), f32 accumulate; the online softmax on the
//     accumulator fragments in registers (exp2 of scores pre-scaled by
//     log2 e; l sums the f32 p); O += P V by wgmma with P as the register A
//     operand: the S fragment re-packed in place into bf16 pairs
//     (FlashAttention-3's layout match), V from shared memory MN-major (the
//     transpose bit), since its d is contiguous.  P is rounded to bf16
//     here; the reference's own dense and chunked attention round P to the
//     input type too (repro/models/layers.py:105, 145);
//   - S(j) and P(j-1) V(j-1) are issued together and step j's softmax runs
//     while P V is still on the tensor cores (FlashAttention-3's
//     intra-warpgroup overlap); the two consumers overlap each other freely.
//     64 keys a step keep S (32), P (16) and O (64 at d = 128) within the
//     168 registers a thread of a 384-thread block has: with 128 keys a
//     step ptxas spilled and serialized the wgmma;
//   - 160 KB of shared memory at d = 128 (q 32 KB, 2 x (k + v) 128 KB).
// * f32 (wgmma would be TF32, which cannot hold f32's 2e-5), and bf16 at
//   d = 16 and 32: the SIMT kernel (namespace simt), f32 FMAs from tiles
//   staged in shared memory as f32.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() (or cudaErrorInvalidValue where a tensor map cannot be
// built) so a refused launch surfaces in the caller.

#include "hopper.cuh"

#include <type_traits>

namespace {

namespace simt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTX = 16;
constexpr int kRows = kBQ / 16;  // rows a thread owns
constexpr int kKeys = kBK / 16;  // keys a thread scores per tile
constexpr float kNegInf = -1e30f;

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

}  // namespace simt

namespace wg {

constexpr int kBM = 128;       // q rows per block: 2 consumer warpgroups x 64
constexpr int kBN = 128;       // keys per k/v tile
constexpr int kSub = 64;       // keys per S product: two per tile
constexpr int kStages = 2;     // the k/v ring
constexpr int kThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kBox = 64;       // bf16 in one 128-byte swizzled row
constexpr int kHalf = kBN * 128;  // one box: 128 rows of 128 bytes
constexpr float kNegInf = -1e30f;
template <int D>
struct Smem {
  static constexpr int kTile = (D / kBox) * kHalf;  // 128 x D, D/64 boxes
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;                   // + stage * kTile
  static constexpr int kV = kK + kStages * kTile;    // + stage * kTile
  static constexpr int kBar = kV + kStages * kTile;  // 9 mbarriers
  static constexpr int kBytes = kBar + 9 * 8 + 1024; // + alignment slack
};

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared
// memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

// S = Q K^T for this warpgroup's 64 rows against 64 keys (half of a k
// tile, 8 KB in): D/16 steps of 16 along d; a step's 32 bytes sit at offset
// 32 (kk % 4) in a 128-byte row of box kk / 4.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_tile,
                                         uint32_t k_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
    wgmma_ss_n64(sc, smem_desc(q_tile + off, 16, 1024),
                 smem_desc(k_rows + off, 16, 1024), kk > 0);
  }
}

// O += P V over 64 keys: 4 steps of 16 keys, each 16 rows of 128 bytes
// further on; V is MN-major, its 64-column boxes LBO = 16 KB apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t v_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pv_product<D>(o, pa[kk], smem_desc(v_rows + kk * 16 * 128, kHalf, 1024));
  }
}

// The online softmax of 64 keys on their S fragments (raw q.k): masked
// scores at -1e30; m in log2 units (scores times log2(e)/sqrt(d)); sc
// becomes p = exp2(score * c - m) in f32, l gains this thread's p; alpha is
// the factor O must be rescaled by before P V is added.
__device__ __forceinline__ void softmax_keys(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool masked, int k0, int row0,
                                             int col0, int t_pad, int causal,
                                             float c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        if (masked) {
          const int key = k0 + 8 * j + col0 + e;
          if (key >= t_pad || (causal && key > row)) x = kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // Key 0 is in the first keys and visible to every row, so m_new is a
    // real score from the first step on, and a masked score's p is 0.
    const float m_new = fmaxf(m[r], mx * c);
    alpha[r] = ex2(m[r] - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = ex2(fmaf(x, c, -m_new));
        sum += x;
      }
    }
    l[r] = l[r] * alpha[r] + sum;  // this thread's columns; summed at the end
    m[r] = m_new;
  }
}

// P as bf16 A fragments: keys 16kk..16kk+15 are S's column blocks 2kk and
// 2kk+1, already in the A operand's thread layout.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i / 2];
  }
}

// Accumulator fragment of wgmma m64nNk16 (f32), thread `lane` of warp `w` of
// the warpgroup: register 4j + 2r + e holds row 16w + lane/4 + 8r, column
// 8j + 2(lane%4) + e.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out, int s, int t_pad,
                          int hq, int hkv, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8u * (1 + st); };
  auto v_full = [&](int st) { return bar + 8u * (3 + st); };
  auto k_empty = [&](int st) { return bar + 8u * (5 + st); };
  auto v_empty = [&](int st) { return bar + 8u * (7 + st); };
  auto k_tile = [&](int st) { return base + L::kK + st * L::kTile; };
  auto v_tile = [&](int st) { return base + L::kV + st * L::kTile; };

  // Blocks start in x-fastest order and the q tile is z, so the tiles with
  // the most causal work go first across all heads and batches.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int kh = h / (hq / hkv);
  const int k_end = causal ? min(q0 + kBM, t_pad) : t_pad;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);  // one arrival per consumer warp
      mbar_init(v_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer: few registers are needed to issue copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int c = 0; c < D / kBox; ++c) {
        tma_load(base + L::kQ + c * kHalf, &qmap, q_full, c * kBox, h, q0,
                 bi);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        const uint32_t ph = (n / kStages) & 1;
        mbar_wait(k_empty(st), ph ^ 1);  // the first round passes at once
        mbar_expect_tx(k_full(st), L::kTile);
#pragma unroll
        for (int c = 0; c < D / kBox; ++c) {
          tma_load(k_tile(st) + c * kHalf, &kmap, k_full(st), c * kBox, kh,
                   n * kBN, bi);
        }
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), L::kTile);
#pragma unroll
        for (int c = 0; c < D / kBox; ++c) {
          tma_load(v_tile(st) + c * kHalf, &vmap, v_full(st), c * kBox, kh,
                   n * kBN, bi);
        }
      }
    }
  } else {
    // Consumers: O (D/2) and S (32) f32 fragments and P (16) per thread.
    // 56 x 128 + 224 x 256 = 64,512 registers, what 384 x 168 took at launch.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const int wg_first = q0 + wg * 64;  // this warpgroup's first row
    const uint32_t q_tile = base + L::kQ + wg * 64 * 128;
    // Step j covers keys 64j..64j+63: half j % 2 of k/v tile j / 2.
    const int n_steps = 2 * n_tiles;
    auto stage = [&](int j) { return (j / 2) % kStages; };
    auto parity = [&](int j) {
      return static_cast<uint32_t>(j / 2 / kStages) & 1;
    };
    auto rows = [&](int j) { return (j % 2) * kSub * 128; };
    // Whether step j holds a key this warpgroup must mask.
    auto masked = [&](int j) {
      return j * kSub + kSub > t_pad ||
             (causal && j * kSub + kSub - 1 > wg_first);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];
    float sc[32];
    uint32_t pa[4][4];

    // Step 0: S, then its softmax (O is still zero).
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, q_tile, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_keys(sc, m, l, alpha, masked(0), 0, row0, col0, t_pad, causal,
                 scale_log2);
    pack_p(pa, sc);

    // Step j: S(j) and P(j-1) V(j-1) issued together; step j's softmax runs
    // while P V is still on the tensor cores.  A k tile is released after
    // its second S, a v tile after its second P V.
    for (int j = 1; j < n_steps; ++j) {
      if (j % 2 == 0) mbar_wait(k_full(stage(j)), parity(j));
      if (j % 2 == 1) mbar_wait(v_full(stage(j - 1)), parity(j - 1));
      fence_regs(sc);
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
      issue_qk<D>(sc, q_tile, k_tile(stage(j)) + rows(j));
      wgmma_commit();
      issue_pv<D>(o, pa, v_tile(stage(j - 1)) + rows(j - 1));
      wgmma_commit();
      wgmma_wait<1>();  // S(j) is done; P V may still run
      fence_regs(sc);
      if (j % 2 == 1 && lane == 0) mbar_arrive(k_empty(stage(j)));
      softmax_keys(sc, m, l, alpha, masked(j), j * kSub, row0, col0, t_pad,
                   causal, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      if (j % 2 == 0 && lane == 0) mbar_arrive(v_empty(stage(j - 1)));
      rescale<D>(o, alpha);
      pack_p(pa, sc);
    }

    // The last step's P V (the second half of the last tile, whose v tile
    // was waited for at the step before).
    const int last = n_steps - 1;
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    issue_pv<D>(o, pa, v_tile(stage(last)) + rows(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(v_empty(stage(last)));

    // out: [b, s, hq, D], contiguous; rows at or past s are not stored.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float denom = lr > 0.0f ? lr : 1.0f;
      const int row = row0 + 8 * r;
      if (row >= s) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<long long>(bi) * s + row) * hq + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                  o[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, Strides qs,
           Strides ks, Strides vs, int b, int s, int t, int t_pad, int hq,
           int hkv, int causal, float scale, cudaStream_t stream) {
  if ((s + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);  // grid z
  }
  CUtensorMap qmap, kmap, vmap;
  if (!encode(&qmap, q, qs, b, s, hq, D) ||
      !encode(&kmap, k, ks, b, t, hkv, D) ||
      !encode(&vmap, v, vs, b, t, hkv, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Smem<D>::kBytes;  // 164,936 bytes at d = 128
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hq, b, (s + kBM - 1) / kBM);
  flash_attention_wgmma<D><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), s, t_pad, hq, hkv,
      causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// The route a call takes, from its dtype and head dim alone: 1 = wgmma (bf16
// at d = 64 and 128), 0 = SIMT.
int route(int dtype, int d) { return dtype == 1 && (d == 64 || d == 128); }

// The SIMT kernel for f32 at every d, and for bf16 at d = 16 and 32 (bf16
// at 64 and 128 takes the wgmma route, so it is not instantiated).
template <typename T>
int dispatch_simt(int d, const void* q, const void* k, const void* v,
                  void* out, Strides qs, Strides ks, Strides vs, int b, int s,
                  int t, int t_pad, int hq, int hkv, int causal, float scale,
                  cudaStream_t stream) {
  if (d == 16) {
    return simt::launch<T, 16>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq,
                               hkv, causal, scale, stream);
  }
  if (d == 32) {
    return simt::launch<T, 32>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq,
                               hkv, causal, scale, stream);
  }
  if constexpr (std::is_same_v<T, float>) {
    if (d == 64) {
      return simt::launch<T, 64>(q, k, v, out, qs, ks, vs, b, s, t, t_pad, hq,
                                 hkv, causal, scale, stream);
    }
    if (d == 128) {
      return simt::launch<T, 128>(q, k, v, out, qs, ks, vs, b, s, t, t_pad,
                                  hq, hkv, causal, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: [b, s, hq, d], k and v: [b, t, hkv, d], each addressed through its
// (batch, seq, head) strides in elements with the head dim contiguous; out:
// a contiguous [b, s, hq, d].  dtype 0 = f32, 1 = bf16 (all four alike);
// d in {16, 32, 64, 128}; hq a multiple of hkv; t <= t_pad.  On the wgmma
// route (bf16, d 64 or 128) every base address and stride of q, k and v must
// be a multiple of 16 bytes.  Returns cudaGetLastError().
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
  if (route(dtype, d)) {
    return d == 128 ? wg::launch<128>(q, k, v, out, qs, ks, vs, b, s, t, t_pad,
                                      hq, hkv, causal, scale, st)
                    : wg::launch<64>(q, k, v, out, qs, ks, vs, b, s, t, t_pad,
                                     hq, hkv, causal, scale, st);
  }
  if (dtype == 0) {
    return dispatch_simt<float>(d, q, k, v, out, qs, ks, vs, b, s, t, t_pad,
                                hq, hkv, causal, scale, st);
  }
  if (dtype == 1) {
    return dispatch_simt<__nv_bfloat16>(d, q, k, v, out, qs, ks, vs, b, s, t,
                                        t_pad, hq, hkv, causal, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// 1 where a call of this dtype and head dim takes the wgmma kernel, else 0.
extern "C" int pollen_flash_attention_route(int dtype, int d) {
  return route(dtype, d);
}

extern "C" const char* pollen_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
