// Split-KV attention for few query rows per kv head (the serving path's
// decode ticks) on Hopper (sm_90a), f32 or bf16 inputs.  Built by
// repro_torch/kernels/build.py with nvcc into a shared library with a
// plain C interface, bound with ctypes
// (repro_torch/kernels/block_attention/ops.py, route "decode").
//
// Replaces, for these calls, the Pallas TPU kernel
//   repro/kernels/block_attention/kernel.py::_attn_kernel
//   (flash_attention_flat), with the port's q_offset and kv_len,
// and computes what csrc/block_attention.cu computes: GQA by index,
// causal / local / bidir masks, soft-capping, masked scores at -2^30,
// output acc / max(l, 1e-30) in the input type.
//
// What bounds it: bytes.  A decode tick reads the whole live KV range
// (2 * kv_lim * nkv * hd elements per batch row) for a handful of
// query rows: at llama3.2-3b's decode, (4, 1, 1057, 24/8, 128), about
// 4 flops per byte read, far below the card's ridge.  So the design is
// about reading each K/V byte once, from many SMs at the same time:
//   * one block per (kv split, batch x KV head): the block packs the
//     g = nh / nkv query heads of its kv head and the Sq query rows
//     into R = Sq * g rows (row r = query r / g, head kvh * g + r % g),
//     so each K/V byte is read once per call, not g times;
//   * the live kv range [k_begin, k_end) (the whole cache [0, Skv)
//     when some row of the call sees no key, so that such a row gets the
//     reference's uniform weights, the mean of V; keys past a split's
//     end weigh 0) is cut into n_split splits of
//     split_len keys (whole 64-key tiles; the plan is
//     block_attention/plan.py::split_plan, chosen from the live range
//     and the SM count so that there are blocks for every SM), and a
//     block walks only its split;
//   * bf16 with at most 16 rows and hd = 16 KS <= 128 (every decode
//     tick of llama3.2-3b and zamba2-2.7b) takes decode_mma: each warp
//     streams 16-key steps of the split with its own online softmax,
//     Q.K^T and P.V on mma.sync m16n8k16 (bf16 operands, f32
//     accumulators), K's fragments loaded from global memory one step
//     ahead and V through a per-warp cp.async ring read by
//     ldmatrix.trans; the four warps merge in order at the end.  The
//     tensor cores are not what it needs, but they turn the per-key
//     arithmetic into a few instructions, so the loads stay in flight;
//     rounding P to bf16 adds about 4e-3 relative error, inside the bf16
//     tolerance of 2e-2;
//   * everything else (f32, more rows, hd above 128 or not a multiple
//     of 16) takes decode_split: K and V tiles loaded with 16-byte
//     vector loads where the pointers, strides and hd allow it (every
//     load of a tile in flight at once, the next tile's issued before
//     the current tile's arithmetic), kept in shared memory as f32;
//     scores, softmax and P.V in f32 on the CUDA cores, as the 2e-4 f32
//     tolerance needs;
//   * each block writes its unnormalised partial (m, l, acc) to f32
//     scratch that the wrapper allocates; a second, small launch merges
//     the splits (max, weights, sums over a fixed tree, each output
//     column summed in split order; no atomics), so the bits depend
//     only on the shapes and kv_len, never on scheduling;
//   * per-row lengths (continuous batching: every batch row decodes at
//     its own position): the wrapper hands in a (B, 6) int32 table of
//     each row's q_offset, kv_lim, live range and split plan, each what
//     a scalar call with that row's length would use
//     (block_attention/plan.py::row_plans).  The grid covers the longest
//     row's splits; a block past its row's n_split returns before it
//     reads anything, and the merge reads only that row's n_split
//     partials, so a row's bits are those of a scalar call at its
//     length, whatever the other rows' lengths.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;                    // keys per tile
constexpr int kLdS = kBK + 1;              // padded row stride of scores
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's

enum Kind { kCausal = 0, kLocal = 1, kBidir = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_acc;                 // (n_split, B * nkv, R, hd)
  float* part_ml;                  // (n_split, B * nkv, R, 2): m, l
  const int* rows;                 // (B, 6) per-row plans, or nullptr
  int Sq, nh, nkv, hd, g, R, BH;
  long long qs_b, qs_s, qs_h;      // element strides of q, k, v
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  int kind, window, kv_lim, q_offset;
  float softcap, scale;
  int k_begin, k_end, split_len, n_split;
  int vec;                         // 16-byte loads of k and v allowed
};

// Batch row b's plan: the call's scalars, or b's row of the per-row
// table (q_offset, kv_lim, k_begin, k_end, split_len, n_split).
struct RowPlan {
  int q_offset, kv_lim, k_begin, k_end, split_len, n_split;
};
__device__ __forceinline__ RowPlan row_plan(const Params& p, int b) {
  if (p.rows == nullptr)
    return {p.q_offset, p.kv_lim, p.k_begin, p.k_end, p.split_len,
            p.n_split};
  const int* r = p.rows + 6 * b;
  return {r[0], r[1], r[2], r[3], r[4], r[5]};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The K and V tiles of rows [r0, r0 + 64) of (S, hd) slices, moved
// through registers into (64, HD + 1) and (64, HD) f32 tiles; rows at or
// past r_end and columns at or past hd are zero.  With 16-byte loads a
// thread holds NL chunks of each tile: every load of a pass is issued
// before the first store, and where one pass holds the whole tile
// (PREFETCH) the next tile's loads are issued before the current tile's
// arithmetic, so one memory latency hides behind it.  Without 16-byte
// loads (unaligned pointers, strides or hd) it falls back to scalar
// loads.
template <typename T, int HD>
struct TileLoader {
  static constexpr int E = 16 / sizeof(T);         // elements per chunk
  static constexpr int PER_ROW = HD / E;
  static constexpr int NL_ALL = kBK * PER_ROW / kThreads;
  static constexpr int NL = NL_ALL < 8 ? NL_ALL : 8;  // chunks per pass
  static constexpr int PASSES = NL_ALL / NL;
  static constexpr bool PREFETCH = PASSES == 1;
  uint4 k[NL], v[NL];

  __device__ __forceinline__ void load(const T* K, const T* V, long long ks,
                                       long long vs, int r0, int r_end,
                                       int hd, int pass) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int idx = threadIdx.x + (pass * NL + i) * kThreads;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * E;
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < r_end && c < hd) {
        k[i] = __ldg(reinterpret_cast<const uint4*>(
            K + (long long)(r0 + r) * ks + c));
        v[i] = __ldg(reinterpret_cast<const uint4*>(
            V + (long long)(r0 + r) * vs + c));
      }
    }
  }

  __device__ __forceinline__ void store(float* sK, float* sV, int pass) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int idx = threadIdx.x + (pass * NL + i) * kThreads;
      const int r = idx / PER_ROW, c = (idx % PER_ROW) * E;
      float x[E], y[E];
      unpack(k[i], x);
      unpack(v[i], y);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sK[r * (HD + 1) + c + e] = x[e];
        sV[r * HD + c + e] = y[e];
      }
    }
  }
};

template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile_scalar(float* dst, const T* src,
                                                 long long rs, int r0,
                                                 int r_end, int hd) {
  for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.0f;
    if (r0 + r < r_end && d < hd)
      x = to_f32(src[(long long)(r0 + r) * rs + d]);
    dst[r * LD + d] = x;
  }
}

// Shared memory of one block, in floats: q (RMAX x HD, scaled; rows at
// or past R zero, so the inner loops need no row guard), the K tile
// (64 x HD + 1), the V tile (64 x HD), scores / probabilities
// (RMAX x 65), and per row the running max, sum and this tile's
// correction.
__host__ __device__ constexpr int smem_floats(int HD, int RMAX) {
  return RMAX * HD + kBK * (HD + 1) + kBK * HD + RMAX * kLdS + 3 * RMAX;
}

// Threads: P.V gives each thread NC-strided columns (CPT of them) of
// RPT rows; Q.K gives thread t the key t % 64 for the rows of one half.
template <typename T, int HD, int RMAX>
__global__ void __launch_bounds__(kThreads) decode_split(Params p) {
  constexpr int LDK = HD + 1;
  constexpr int NC = HD < kThreads ? HD : kThreads;
  constexpr int RG = kThreads / NC;
  constexpr int CPT = HD / NC;
  constexpr int RPT = (RMAX + RG - 1) / RG;
  constexpr int SPT = (RMAX + 1) / 2;
  extern __shared__ float smem[];
  const int R = p.R;
  float* sQ = smem;
  float* sK = sQ + RMAX * HD;
  float* sV = sK + kBK * LDK;
  float* sS = sV + kBK * HD;
  float* sM = sS + RMAX * kLdS;
  float* sL = sM + RMAX;
  float* sC = sL + RMAX;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.nkv, kvh = bh % p.nkv;
  const RowPlan rp = row_plan(p, b);
  if (split >= rp.n_split) return;   // past this row's plan
  const int s_begin = rp.k_begin + split * rp.split_len;
  const int s_end = min(rp.k_end, s_begin + rp.split_len);
  const T* K = static_cast<const T*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const T* V = static_cast<const T*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  const T* Q = static_cast<const T*>(p.q) + b * p.qs_b;

  // the first tile's loads go out before q is staged
  using Loader = TileLoader<T, HD>;
  Loader ld;
  const bool vec = p.vec != 0;
  if (vec && Loader::PREFETCH && s_begin < s_end)
    ld.load(K, V, p.ks_s, p.vs_s, s_begin, s_end, p.hd, 0);

  for (int i = tid; i < RMAX * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int h = kvh * p.g + r % p.g;
    sQ[i] = r < R && d < p.hd
                ? to_f32(Q[(r / p.g) * p.qs_s + h * p.qs_h + d]) * p.scale
                : 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  const int tcol = tid % NC, tgrp = tid / NC;
  const int key = tid % kBK, half = tid / kBK;

  for (int k0 = s_begin; k0 < s_end; k0 += kBK) {
    __syncthreads();               // the last tile's reads are done
    if (!vec) {
      load_tile_scalar<T, HD, LDK>(sK, K, p.ks_s, k0, s_end, p.hd);
      load_tile_scalar<T, HD, HD>(sV, V, p.vs_s, k0, s_end, p.hd);
    } else if (Loader::PREFETCH) {
      ld.store(sK, sV, 0);         // this tile, loaded one step ahead
      if (k0 + kBK < s_end)
        ld.load(K, V, p.ks_s, p.vs_s, k0 + kBK, s_end, p.hd, 0);
    } else {
#pragma unroll 1
      for (int pass = 0; pass < Loader::PASSES; ++pass) {
        ld.load(K, V, p.ks_s, p.vs_s, k0, s_end, p.hd, pass);
        ld.store(sK, sV, pass);
      }
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) s[i] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kv = sK[key * LDK + d];
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        s[i] = fmaf(sQ[(half + 2 * i) * HD + d], kv, s[i]);
    }
    const int kp = k0 + key;
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int r = half + 2 * i;
      if (r >= R) continue;
      const int qp = rp.q_offset + r / p.g;
      float x = s[i];
      if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
      bool ok = kp < rp.kv_lim;
      if (p.kind == kCausal) ok = ok && kp <= qp;
      else if (p.kind == kLocal) ok = ok && kp <= qp && kp > qp - p.window;
      sS[r * kLdS + key] = kp >= s_end ? -INFINITY : ok ? x : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      float a = sS[r * kLdS + lane], c = sS[r * kLdS + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      a = expf(a - m_new);
      c = expf(c - m_new);
      sS[r * kLdS + lane] = a;
      sS[r * kLdS + lane + 32] = c;
      float sum = a + c;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = tgrp + RG * i;
      const float corr = sC[r];    // rows past R: never stored
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[j * HD + tcol + NC * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pr = sS[(tgrp + RG * i) * kLdS + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pr, vv[c], acc[i][c]);
      }
    }
  }

  // sM and sL were last written before the last barrier
  const long long part = (long long)split * p.BH + bh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tgrp + RG * i;
    if (r >= R) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tcol + NC * c;
      if (d < p.hd) p.part_acc[(part * R + r) * p.hd + d] = acc[i][c];
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    p.part_ml[(part * R + r) * 2] = sM[r];
    p.part_ml[(part * R + r) * 2 + 1] = sL[r];
  }
}

// ---- the tensor-core path: bf16, R <= 16 rows, hd = 16 KS <= 128 ----
//
// Each warp streams its own 16-key steps of the block's split (steps
// w, w + 4, ...) with its own online softmax, and the four warps are
// merged in order at the end, so the loop has no block barrier.  Per
// step: S (16 rows x 16 keys) = Q . K^T by mma.sync m16n8k16 (bf16
// operands, f32 accumulators; Q's fragments stay in registers, K's come
// straight from global memory as 4-byte pairs, the next step's issued
// before this step's arithmetic), the softmax in f32 registers, and
// O += P . V with P in bf16 from registers and V through a per-warp,
// double-buffered cp.async ring in shared memory (rows padded by 16
// bytes, so ldmatrix.trans reads them without bank conflicts).  Rows at
// or past R are zero in Q and never stored.
constexpr int kMmaRows = 16;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// 16 bytes global -> shared; `bytes` 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p,
                                            bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
}

template <int KS>
struct MmaSmem {
  static constexpr int HD = 16 * KS;
  static constexpr int ROW = HD * 2 + 16;          // padded V row, bytes
  static constexpr int V_BYTES = 4 * 2 * 16 * ROW;  // 4 warps x 2 stages
  static constexpr int MERGE_BYTES =
      4 * (kMmaRows * HD + 2 * kMmaRows) * (int)sizeof(float);
  static constexpr int BYTES = V_BYTES > MERGE_BYTES ? V_BYTES : MERGE_BYTES;
};

template <int KS>
__global__ void __launch_bounds__(kThreads) decode_mma(Params p) {
  constexpr int HD = 16 * KS, NT = 2 * KS;
  using S = MmaSmem<KS>;
  __shared__ __align__(16) uint8_t smem[S::BYTES];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.nkv, kvh = bh % p.nkv;
  const RowPlan rp = row_plan(p, b);
  if (split >= rp.n_split) return;   // past this row's plan
  const int s_begin = rp.k_begin + split * rp.split_len;
  const int s_end = min(rp.k_end, s_begin + rp.split_len);
  const int n_steps = s_end > s_begin ? (s_end - s_begin + 15) / 16 : 0;
  using bf16 = __nv_bfloat16;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.qs_b;
  const uint32_t sV = smem_u32(smem) + warp * 2 * 16 * S::ROW;

  // K fragments of one step: key kb + 8 nt + g, columns 16 kk + 2 t (+8)
  auto load_k = [&](uint32_t (&kf)[2][KS][2], int kb) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int key = kb + 8 * nt + g;
      const bf16* row = K + (long long)key * p.ks_s + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        kf[nt][kk][0] = ld_pair(row + 16 * kk, key < s_end);
        kf[nt][kk][1] = ld_pair(row + 16 * kk + 8, key < s_end);
      }
    }
  };
  // V rows [kb, kb + 16) into this warp's stage buffer
  auto load_v = [&](int kb, int stage) {
    constexpr int CHUNKS = 16 * HD / 8;
#pragma unroll
    for (int i = lane; i < CHUNKS; i += 32) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const bool ok = kb + r < s_end;
      cp_async16(sV + stage * 16 * S::ROW + r * S::ROW + c * 2,
                 V + (long long)(ok ? kb + r : s_begin) * p.vs_s + c,
                 ok ? 16 : 0);
    }
  };

  // Q fragments: rows g and g + 8 (query r / g_, head kvh g_ + r % g_)
  uint32_t qa[KS][4];
  {
    const int r0 = g, r1 = g + 8;
    const bf16* q0 = Q + (r0 / p.g) * p.qs_s + (kvh * p.g + r0 % p.g) * p.qs_h;
    const bf16* q1 = Q + (r1 / p.g) * p.qs_s + (kvh * p.g + r1 % p.g) * p.qs_h;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = ld_pair(q0 + 16 * kk + 2 * t, r0 < p.R);
      qa[kk][1] = ld_pair(q1 + 16 * kk + 2 * t, r1 < p.R);
      qa[kk][2] = ld_pair(q0 + 16 * kk + 8 + 2 * t, r0 < p.R);
      qa[kk][3] = ld_pair(q1 + 16 * kk + 8 + 2 * t, r1 < p.R);
    }
  }
  // the live keys [lo, hi) of rows g and g + 8
  const int qp0 = rp.q_offset + g / p.g, qp1 = rp.q_offset + (g + 8) / p.g;
  const int hi0 = p.kind == kBidir ? rp.kv_lim : min(rp.kv_lim, qp0 + 1);
  const int hi1 = p.kind == kBidir ? rp.kv_lim : min(rp.kv_lim, qp1 + 1);
  const int lo0 = p.kind == kLocal ? qp0 - p.window + 1 : INT_MIN;
  const int lo1 = p.kind == kLocal ? qp1 - p.window + 1 : INT_MIN;

  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  uint32_t kf[2][KS][2], kn[2][KS][2];
  if (warp < n_steps) {
    load_k(kf, s_begin + 16 * warp);
    load_v(s_begin + 16 * warp, 0);
  }
  cp_async_commit();
  int stage = 0;
  for (int st = warp; st < n_steps; st += 4, stage ^= 1) {
    const int kb = s_begin + 16 * st;
    const bool more = st + 4 < n_steps;
    if (more) {
      load_k(kn, kb + 64);
      load_v(kb + 64, stage ^ 1);
    }
    cp_async_commit();

    float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      mma_bf16(c[0], qa[kk], kf[0][kk][0], kf[0][kk][1]);
      mma_bf16(c[1], qa[kk], kf[1][kk][0], kf[1][kk][1]);
    }
    // c[nt][e]: row g + 8 (e >> 1), key kb + 8 nt + 2 t + (e & 1)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = c[nt][e] * p.scale;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        const int kp = kb + 8 * nt + 2 * t + (e & 1);
        const bool ok = (e & 2) ? kp >= lo1 && kp < hi1 : kp >= lo0 && kp < hi0;
        c[nt][e] = kp >= s_end ? -INFINITY : ok ? x : kNegInf;
        if (e & 2) mx1 = fmaxf(mx1, c[nt][e]);
        else mx0 = fmaxf(mx0, c[nt][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[nt][e] = expf(c[nt][e] - ((e & 2) ? n1 : n0));
        if (e & 2) s1 += c[nt][e];
        else s0 += c[nt][e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }
    const uint32_t pa[4] = {pack_bf16(c[0][0], c[0][1]),
                            pack_bf16(c[0][2], c[0][3]),
                            pack_bf16(c[1][0], c[1][1]),
                            pack_bf16(c[1][2], c[1][3])};

    cp_async_wait1();              // this step's V has landed
    __syncwarp();
    const uint32_t vrow = sV + stage * 16 * S::ROW +
                          ((lane & 7) + 8 * ((lane >> 3) & 1)) * S::ROW +
                          8 * (lane >> 4) * 2;
#pragma unroll
    for (int np = 0; np < KS; ++np) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vrow + 16 * np * 2);
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();                  // the buffer is free for step st + 8
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        kf[nt][kk][0] = kn[nt][kk][0];
        kf[nt][kk][1] = kn[nt][kk][1];
      }
  }

  // merge the four warps in order: (m, l, O) of each row through shared
  // memory, then the block's partial for rows < R
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* sO = reinterpret_cast<float*>(smem);     // [4][16][HD]
  float* sML = sO + 4 * kMmaRows * HD;            // [4][16][2]
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float* r0 = sO + (warp * kMmaRows + g) * HD + 8 * i + 2 * t;
    r0[0] = o[i][0];
    r0[1] = o[i][1];
    r0[8 * HD] = o[i][2];
    r0[8 * HD + 1] = o[i][3];
  }
  if (t == 0) {
    sML[(warp * kMmaRows + g) * 2] = m0;
    sML[(warp * kMmaRows + g) * 2 + 1] = l0;
    sML[(warp * kMmaRows + g + 8) * 2] = m1;
    sML[(warp * kMmaRows + g + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  const long long part = (long long)split * p.BH + bh;
  for (int i = tid; i < p.R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, sML[(w * kMmaRows + r) * 2]);
    float L = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = expf(sML[(w * kMmaRows + r) * 2] - M);
      L += wt * sML[(w * kMmaRows + r) * 2 + 1];
      acc += wt * sO[(w * kMmaRows + r) * HD + d];
    }
    p.part_acc[(part * p.R + r) * p.hd + d] = acc;
    if (d == 0) {
      p.part_ml[(part * p.R + r) * 2] = M;
      p.part_ml[(part * p.R + r) * 2 + 1] = L;
    }
  }
}

// Block-wide reduction of one value per thread over a fixed tree (the
// same order every call); every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                 // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w)
    x = MAX ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One block per (batch x kv head, row): M = max_s m_s, the weights
// w_s = exp(m_s - M) in shared memory, L = sum_s w_s l_s over a fixed
// tree, and each output column the sum over s, in split order, of
// w_s acc_s, over the n_split splits of the batch row's plan.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine(Params p) {
  extern __shared__ float w[];     // n_split weights, then 4 for red
  float* red = w + p.n_split;
  const int bh = blockIdx.x / p.R, r = blockIdx.x % p.R;
  const int b = bh / p.nkv, kvh = bh % p.nkv;
  const int n_split = row_plan(p, b).n_split;
  const long long stride = (long long)p.BH * p.R;   // between splits
  const long long row = (long long)bh * p.R + r;
  float m = -3.0e38f;
  for (int s = threadIdx.x; s < n_split; s += kThreads)
    m = fmaxf(m, p.part_ml[(s * stride + row) * 2]);
  const float M = block_reduce<true>(m, red);
  float l = 0.0f;
  for (int s = threadIdx.x; s < n_split; s += kThreads) {
    const float ws = expf(p.part_ml[(s * stride + row) * 2] - M);
    w[s] = ws;
    l += ws * p.part_ml[(s * stride + row) * 2 + 1];
  }
  const float L = block_reduce<false>(l, red);   // its barriers publish w
  const float inv_l = 1.0f / fmaxf(L, 1e-30f);
  const int qi = r / p.g, h = kvh * p.g + r % p.g;
  T* O = static_cast<T*>(p.o) + (((long long)b * p.Sq + qi) * p.nh + h) *
                                    p.hd;
  const float* acc = p.part_acc + row * p.hd;
  for (int d = threadIdx.x; d < p.hd; d += kThreads) {
    float o = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s)
      o = fmaf(w[s], acc[s * stride * p.hd + d], o);
    store(O + d, o * inv_l);
  }
}

template <typename T>
int launch_combine(const Params& p, void* stream) {
  const int cmem = (int)sizeof(float) * (p.n_split + kThreads / 32);
  decode_combine<T>
      <<<p.BH * p.R, kThreads, cmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD, int RMAX>
int launch(const Params& p, void* stream) {
  const int smem = (int)sizeof(float) * smem_floats(HD, RMAX);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, HD, RMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (p.n_split > 0) {
    dim3 grid(p.n_split, p.BH);
    decode_split<T, HD, RMAX>
        <<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_combine<T>(p, stream);
}

template <int KS>
int launch_mma(const Params& p, void* stream) {
  if (p.n_split > 0) {
    dim3 grid(p.n_split, p.BH);
    decode_mma<KS><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_combine<__nv_bfloat16>(p, stream);
}

int launch_mma_hd(const Params& p, void* stream) {
  switch (p.hd / 16) {
    case 1: return launch_mma<1>(p, stream);
    case 2: return launch_mma<2>(p, stream);
    case 3: return launch_mma<3>(p, stream);
    case 4: return launch_mma<4>(p, stream);
    case 5: return launch_mma<5>(p, stream);
    case 6: return launch_mma<6>(p, stream);
    case 7: return launch_mma<7>(p, stream);
    case 8: return launch_mma<8>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD>
int launch_rows(const Params& p, void* stream) {
  if (p.R <= 4) return launch<T, HD, 4>(p, stream);
  if (p.R <= 16) return launch<T, HD, 16>(p, stream);
  return launch<T, HD, 64>(p, stream);
}

template <typename T>
int launch_hd(const Params& p, void* stream) {
  if (p.hd <= 32) return launch_rows<T, 32>(p, stream);
  if (p.hd <= 64) return launch_rows<T, 64>(p, stream);
  if (p.hd <= 128) return launch_rows<T, 128>(p, stream);
  return launch_rows<T, 256>(p, stream);
}

}  // namespace

// Launches the split pass and the combine pass on `stream` and returns
// the CUDA error code (0 when both launches were accepted).  dtype 0 =
// f32, 1 = bf16 (q, k, v and o share it).  Strides are in elements; the
// last dimension of q, k and v is contiguous.  kind 0 = causal, 1 =
// local, 2 = bidir.  Split s covers keys [k_begin + s * split_len,
// min(k_end, k_begin + (s + 1) * split_len)).  part_acc holds n_split *
// B * nkv * R * hd floats and part_ml n_split * B * nkv * R * 2.  With
// `rows` (a device array of B x 6 ints: q_offset, kv_lim, k_begin,
// k_end, split_len, n_split per batch row) those come from each row's
// entry instead of the scalars, and n_split is the largest row's.  The
// wrapper checks R = Sq * (nh / nkv) <= 64, 1 <= hd <= 256,
// B * nkv <= 65535, and sets vec only when k and v allow 16-byte loads.
extern "C" int attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, float* part_acc,
    float* part_ml, const int* rows, int dtype, int B, int Sq, int nh, int nkv, int hd,
    long long qs_b, long long qs_s, long long qs_h, long long ks_b,
    long long ks_s, long long ks_h, long long vs_b, long long vs_s,
    long long vs_h, int kind, int window, int kv_lim, int q_offset,
    float softcap, float scale, int k_begin, int k_end, int split_len,
    int n_split, int vec, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  const int g = nh / nkv;
  Params p{q, k, v, o, part_acc, part_ml, rows, Sq, nh, nkv, hd, g, Sq * g,
           B * nkv, qs_b, qs_s, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h,
           kind, window, kv_lim, q_offset, softcap, scale, k_begin, k_end,
           split_len, n_split, vec};
  if (p.R > 64 || split_len % kBK) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && vec && p.R <= kMmaRows && hd % 16 == 0 && hd <= 128)
    return launch_mma_hd(p, stream);
  if (dtype == 0) return launch_hd<float>(p, stream);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, stream);
  return (int)cudaErrorInvalidValue;
}
