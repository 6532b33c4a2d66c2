// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16 q, k,
// v with hd a multiple of 16 up to 128, the serving path's prefills.
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, bound with ctypes
// (repro_torch/kernels/block_attention/ops.py, route "tc").
//
// Replaces, for these calls, the Pallas TPU kernel
//   repro/kernels/block_attention/kernel.py::_attn_kernel
//   (flash_attention_flat), with the port's q_offset and kv_len,
// and computes what csrc/block_attention.cu computes: GQA by index,
// causal / local / bidir masks, soft-capping, masked scores at -2^30,
// output acc / max(l, 1e-30) in bf16.
//
// What bounds it: operations.  A prefill does 4 * hd flops per live
// (query, key) pair against |q| + |k| + |v| + |o| bytes, hundreds of
// flops per byte at the path's shapes, so the bound is the tensor
// cores' bf16 rate.  The design is FlashAttention-3's shape:
//   * a CTA of 128 q rows and 384 threads: warpgroups 0 and 1 are the
//     consumers, 64 q rows each; warpgroup 2 is the producer, and one of
//     its threads issues every copy (setmaxnreg moves registers from the
//     producer to the consumers);
//   * TMA: tensor maps over q, k and v as they lie in memory (4-D:
//     hd, heads, sequence, batch, with the caller's strides), built per
//     call on the host; 64-column boxes with the 128-byte swizzle, so
//     hd 128 is two boxes and hd 80 is two boxes whose columns 80..127
//     the TMA fills with zeros.  Ragged Sq and Skv come from the same
//     zero fill of out-of-bound rows: no padding copy is made;
//   * K and V tiles of 128 keys go through a two-stage ring in shared
//     memory; "full" mbarriers (one each for K and V, so Q.K^T can start
//     before V lands) report the TMA's bytes, "empty" mbarriers the
//     consumers' release;
//   * S = Q.K^T by wgmma m64n128k16 (bf16 operands from shared memory,
//     K-major both, f32 accumulators in registers);
//   * the online softmax runs on S in f32 registers: the scale
//     multiplies S in f32 (q is never scaled in bf16), then soft-cap and
//     mask, with row max and sum reduced over the four lanes of a row.
//     It is straight-line code over each thread's 64 scores, with one
//     uniform branch per step and none per element: with a branch per
//     element it took most of a tile's cycles, since two consumer warps
//     per scheduler hide latency only through the elements'
//     independence; exp2 is the SFU's ex2.approx;
//   * P is rounded to bf16 in registers and used as the A operand of
//     O += P.V by wgmma m64nHDk16 (the accumulator fragment of S is the
//     A fragment of P), with V from shared memory as an MN-major
//     operand.  Rounding P to bf16 adds about 4e-3 relative error to O,
//     inside the bf16 tolerance of 2e-2;
//   * kv tiles that the mask leaves empty for the CTA are never loaded;
//     only tiles on the diagonal, the window's edge or past kv_len are
//     masked, element by element.  When some row of the call sees no key
//     (`full`, block_attention/plan.py::has_empty_row), every CTA walks
//     the whole cache [0, Skv) instead, so such a row gets the
//     reference's uniform weights (the mean of V); keys past the walked
//     range (the TMA's zero fill) weigh 0;
//   * no split-K and no atomics: the bits depend only on the inputs.
// Not yet here: FlashAttention-3's overlap of one tile's softmax with the
// next tile's wgmmas inside a warpgroup (a first try, with P.V of tile j
// in flight during the softmax of tile j + 1, ran slower at llama's
// trunk prefill), and the ping-pong scheduling of the two warpgroups.
// cuTensorMapEncodeTiled is taken from the driver through
// cudaGetDriverEntryPoint(ByVersion), so the library links nothing
// beyond the CUDA runtime; it, the mbarrier, TMA and wgmma helpers live
// in sm90.cuh, shared with cut_fusion.cu and mamba2_scan_chunked.cu.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;            // q rows per CTA
constexpr int kBK = 128;            // keys per kv tile
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kBoxBytes = 64 * 128; // a 64-row box of 64 bf16 columns
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's
constexpr float kLog2e = 1.4426950408889634f;

enum Kind { kCausal = 0, kLocal = 1, kBidir = 2 };

struct Params {
  __nv_bfloat16* o;
  int Sq, Skv, nh, nkv, hd;
  int kind, window, kv_lim, q_offset;
  int full;                        // walk [0, Skv): some row sees no key
  float softcap, scale;
};

#define D8(b)                                                            \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),            \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// S (64 x 128) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem,
// K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64) += P (64 x 16, registers) . V (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += P (64 x 16, registers) . V (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the SFU (ex2.approx, flush to zero): about 2 ulp, far inside
// the bf16 tolerance; masked scores give exactly 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// --- the kernel ------------------------------------------------------------

// Shared memory, from a 1024-byte aligned base: Q (2 warpgroups x NB
// boxes of 64 rows), then K and V (kStages x NB boxes of kBK rows
// each), then the barriers.
template <int HDP>
struct Layout {
  static constexpr int NB = HDP / 64;
  static constexpr int Q = 0;
  static constexpr int K = Q + 2 * NB * kBoxBytes;
  static constexpr int V = K + kStages * NB * 2 * kBoxBytes;
  static constexpr int BAR = V + kStages * NB * 2 * kBoxBytes;
  static constexpr int BYTES = BAR + 64 + 1024;   // + alignment slack
  static constexpr int TILE_TX = NB * 2 * kBoxBytes;  // one K or V tile
};

// HDP: hd padded to 64 or 128 (the V tile and O); KS = hd / 16, the
// k-steps of Q.K^T (a compile-time count keeps the wgmmas of one product
// in one uninterrupted group).
template <int HDP, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    attn_tc(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ Params p) {
  using L = Layout<HDP>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base + L::Q, sK = base + L::K, sV = base + L::V;
  const uint32_t bar_q = base + L::BAR;
  // full K, full V and empty for each stage
  auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto bar_e = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };

  const int tid = threadIdx.x;
  // heavier (later) q tiles of a causal prefill first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int kvh = h / (p.nh / p.nkv);

  // the live kv range of the CTA, in whole tiles from k_begin
  const int pos_first = p.q_offset + q0;
  const int pos_last = p.q_offset + min(q0 + kBQ, p.Sq) - 1;
  int k_end = p.kv_lim, k_begin = 0;
  if (p.kind != kBidir) k_end = min(k_end, pos_last + 1);
  if (p.kind == kLocal) k_begin = max(0, pos_first - p.window + 1);
  k_begin = (k_begin / kBK) * kBK;
  if (p.full) {
    k_begin = 0;
    k_end = p.Skv;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      mbar_expect_tx(bar_q, 2 * NB * kBoxBytes);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NB; ++c)
          tma_load4(sQ + (w * NB + c) * kBoxBytes, &tq, bar_q, 64 * c, h,
                   q0 + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, ph = (j / kStages) & 1;
        const int k0 = k_begin + j * kBK;
        mbar_wait(bar_e(s), ph ^ 1);
        mbar_expect_tx(bar_k(s), L::TILE_TX);
        for (int c = 0; c < NB; ++c)
          tma_load4(sK + (s * NB + c) * 2 * kBoxBytes, &tk, bar_k(s), 64 * c,
                   kvh, k0, b);
        mbar_expect_tx(bar_v(s), L::TILE_TX);
        for (int c = 0; c < NB; ++c)
          tma_load4(sV + (s * NB + c) * 2 * kBoxBytes, &tv, bar_v(s), 64 * c,
                   kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int qp0 = p.q_offset + row0, qp1 = qp0 + 8;
    const int wg_first = p.q_offset + q0 + 64 * wg;
    const int wg_last = wg_first + 63;
    // the live keys [lo, hi) of this thread's two rows
    const int hi0 = p.kind == kBidir ? p.kv_lim : min(p.kv_lim, qp0 + 1);
    const int hi1 = p.kind == kBidir ? p.kv_lim : min(p.kv_lim, qp1 + 1);
    const int lo0 = p.kind == kLocal ? qp0 - p.window + 1 : INT_MIN;
    const int lo1 = p.kind == kLocal ? qp1 - p.window + 1 : INT_MIN;
    const uint32_t sQw = sQ + wg * NB * kBoxBytes;

    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, ph = (j / kStages) & 1;
      const int k0 = k_begin + j * kBK;
      const uint32_t sKs = sK + s * NB * 2 * kBoxBytes;
      const uint32_t sVs = sV + s * NB * 2 * kBoxBytes;

      // S = Q . K^T over hd in steps of 16 (32 bytes of a 128-byte row)
      float sc[kBK / 2];
      mbar_wait(bar_k(s), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss_n128(sc,
                      desc(sQw + (kk / 4) * kBoxBytes + (kk % 4) * 32, 1, 64),
                      desc(sKs + (kk / 4) * 2 * kBoxBytes + (kk % 4) * 32, 1,
                           64),
                      kk > 0);
      wg_commit();
      wg_wait();
      reg_fence(sc);

      // scale, soft-cap and mask in f32, as straight-line code over the
      // 64 elements (one uniform branch per step, none per element: with
      // two consumer warps per scheduler, the elements' independence is
      // what hides latency).  Element i of sc is row row0 + 8 * ((i >> 1)
      // & 1), key k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
      if (p.softcap > 0.0f) {
        const float cap = p.softcap, inv = 1.0f / p.softcap;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i)
          sc[i] = cap * tanhf(sc[i] * p.scale * inv);
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) sc[i] *= p.scale;
      }
      if (k0 + kBK > p.kv_lim ||
          (p.kind != kBidir && k0 + kBK - 1 > wg_first) ||
          (p.kind == kLocal && k0 <= wg_last - p.window)) {
        // key kp is live for the row at position qp when lo <= kp < hi
        const int kb = k0 + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int kp = kb + 8 * (i >> 2) + (i & 1);
          const bool ok = kp >= ((i & 2) ? lo1 : lo0) &&
                          kp < ((i & 2) ? hi1 : hi0);
          sc[i] = kp >= k_end ? -INFINITY : ok ? sc[i] : kNegInf;
        }
      }
      float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i & 2) | ((i >> 2) & 1)] = fmaxf(mx[(i & 2) | ((i >> 2) & 1)],
                                             sc[i]);
      float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = fast_exp2((m0 - n0) * kLog2e);
      const float c1 = fast_exp2((m1 - n1) * kLog2e);
      m0 = n0;
      m1 = n1;
      float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        sc[i] = fast_exp2((sc[i] - ((i & 2) ? n1 : n0)) * kLog2e);
        sum[(i & 2) | ((i >> 2) & 1)] += sc[i];
      }
      float s0 = sum[0] + sum[1], s1 = sum[2] + sum[3];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) o[i] *= (i & 2) ? c1 : c0;

      // P in bf16 as the A fragment: k-step kk takes the accumulator
      // elements of key columns [16 kk, 16 kk + 16)
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P . V: V's rows are keys (128 bytes of hd per row and box),
      // read as an MN-major operand; LBO steps to the next 64 columns,
      // SBO to the next 8 keys
      mbar_wait(bar_v(s), ph);
      wg_fence();
      reg_fence(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs(o, pa[kk], desc(sVs + kk * 16 * 128, 2 * kBoxBytes / 16, 64));
      wg_commit();
      wg_wait();
      reg_fence(o);
      mbar_arrive(bar_e(s));
    }

    // epilogue: O / max(l, 1e-30) in bf16, two columns per store
    const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
    const int row1 = row0 + 8;
    __nv_bfloat16* o0 = p.o + (((long long)b * p.Sq + row0) * p.nh + h) * p.hd;
    __nv_bfloat16* o1 = p.o + (((long long)b * p.Sq + row1) * p.nh + h) * p.hd;
#pragma unroll
    for (int c = 0; c < HDP / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      if (col >= p.hd) continue;
      if (row0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(o[4 * c] * i0, o[4 * c + 1] * i0);
      if (row1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(o[4 * c + 2] * i1, o[4 * c + 3] * i1);
    }
  }
}

// A 4-D map (hd, heads, seq, batch) over a bf16 tensor with element
// strides s_h, s_s, s_b; boxes of 64 columns x 1 head x `rows` x 1.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int seq,
              int batch, long long s_b, long long s_s, long long s_h,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

template <int KS>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, void* stream) {
  constexpr int HDP = KS <= 4 ? 64 : 128;
  const int smem = Layout<HDP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_tc<HDP, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, B * p.nh);
  attn_tc<HDP, KS>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 when the
// launch was accepted), or -1 when a tensor map could not be encoded.
// q (B, Sq, nh, hd), k and v (B, Skv, nkv, hd), o (B, Sq, nh, hd)
// contiguous, all bf16; strides in elements, the last dimension
// contiguous.  kind 0 = causal, 1 = local, 2 = bidir; full = 1 walks
// every key of [0, Skv) (some row sees no key).  The wrapper
// checks hd % 16 == 0, hd <= 128, 16-byte aligned pointers and strides
// (TMA's rule), nh % nkv == 0 and B * nh <= 65535.
extern "C" int attention_prefill_sm90_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Skv, int nh, int nkv, int hd, long long qs_b, long long qs_s,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, int kind, int window,
    int kv_lim, int q_offset, int full, float softcap, float scale,
    void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, hd, nh, Sq, B, qs_b, qs_s, qs_h, 64) ||
      !make_map(&tk, k, hd, nkv, Skv, B, ks_b, ks_s, ks_h, kBK) ||
      !make_map(&tv, v, hd, nkv, Skv, B, vs_b, vs_s, vs_h, kBK))
    return -1;
  Params p{static_cast<__nv_bfloat16*>(o), Sq, Skv, nh, nkv, hd, kind,
           window, kv_lim, q_offset, full, softcap, scale};
  switch (hd / 16) {
    case 1: return launch<1>(tq, tk, tv, p, B, stream);
    case 2: return launch<2>(tq, tk, tv, p, B, stream);
    case 3: return launch<3>(tq, tk, tv, p, B, stream);
    case 4: return launch<4>(tq, tk, tv, p, B, stream);
    case 5: return launch<5>(tq, tk, tv, p, B, stream);
    case 6: return launch<6>(tq, tk, tv, p, B, stream);
    case 7: return launch<7>(tq, tk, tv, p, B, stream);
    case 8: return launch<8>(tq, tk, tv, p, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}
