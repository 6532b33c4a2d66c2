// The PyVertical cut layer for Hopper (sm_90a): the owners' cut
// activations combined and fed into the trunk's input projection in one
// kernel, f32 or bf16 inputs.  Built by repro_torch/kernels/build.py with
// nvcc into a shared library with a plain C interface, bound with ctypes
// (repro_torch/kernels/cut_fusion/ops.py).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/cut_fusion/kernel.py::_cut_kernel
//   (cut_fusion_raw, wrapped by cut_fusion/ops.py)
// and computes what it computes, for z (P, T, K) and w (Pw, K, D), both
// contiguous, into out (T, D) in z's type:
//   concat:  out = sum_p z_p @ w_p                      (Pw == P)
//   sum:     out = (sum_p z_p) @ w_0
//   mean:    out = ((sum_p z_p) / P) @ w_0
// with f32 accumulation; the (T, P*K) concatenation is never built.
// For sum and mean the P owners' z values are added in f32 (p = 0, 1,
// ...) while the z tile is staged, and mean divides that f32 sum by P
// (true division), so one product runs instead of the TPU kernel's P.
// The TPU kernel scales each z_p by 1/P in z's own type before its
// product; the two orders agree within the reference's tolerances
// (2e-4 in f32, 2e-2 in bf16), and the plain version (ref.py) takes the
// port's order.
//
// What bounds it: at the training path's shape (2, 128, 64) x
// (2, 64, 500) the work is 16.4 MFLOP against 0.58 MB, 0.25 us of f32
// FMAs at the card's peak: latency and the number of SMs at work bound
// it.  At the reference benchmark's (2, 4096, 512) x (2, 512, 1024) the
// f32 FMA rate bounds the f32 route and the tensor cores' rate the bf16
// one.  PR 14's kernel gave each 64 x 64 output tile one block that ran
// staging loads, a barrier and FMAs in a serial chain with nothing in
// flight: 16 blocks on 132 SMs at the batch shape, ~12 us flat from T 32
// to T 242, bf16 widened to f32 on the CUDA cores.  The two routes here
// (block plan: kernels/cut_fusion/plan.py):
//
// fma (every f32 call; bf16 calls TMA cannot read): a tile plan that
// fills the card (16 x 32 output tiles, 128 blocks, at the batch shape;
// 128 x 128 tiles of 256 threads with 8 x 8 outputs a thread at the
// benchmark shape), and a ring of up to 4 stages over the chunks of
// (owner, k): each stage the z tile (rows padded by 4 floats) and the w
// tile, loaded by cp.async (16 bytes, zero-filled past the edge) when
// the rows are 16-byte aligned, else by plain loads.  At the path's
// shapes the whole (p, k) depth, 4 chunks, is in flight at once; the
// FMAs of chunk c run while chunks c + 1.. land.  For sum and mean a
// stage holds every owner's z tile, added in shared memory in owner
// order (and divided by P for mean) before the FMAs.
// Invariant: every output is one f32 accumulator, fed by FMAs in (p,
// then k) order by one thread, whatever the tile: no split-K, no
// atomics, no reordered partial sums.  So an output row's bits do not
// depend on T, the tile plan or the call; they are PR 14's bits, and
// split == joint and microbatched == oracle stay bitwise on the card.
//
// tc (bf16 with k and d multiples of 8 and 16-byte aligned tensors): one
// warpgroup per 128 x 128 output tile, wgmma m64n128k16 (bf16 operands
// from shared memory, f32 accumulators in registers), the contraction
// over (owner p, 64-wide k box) through 3-D tensor maps over z (K, T, P)
// and w (D, K, P) — boxes of 64 x 128 and 64 x 64 with the 128-byte
// swizzle, z's box K-major and w's MN-major — so the concat is never
// built; ragged T, k and d come from the TMA's zero fill and the masked
// epilogue.  A ring of up to 4 stages, one mbarrier each, the next
// stage's TMA issued as soon as a stage is free.  For sum and mean the
// owners' boxes are added in f32 in shared memory (element by element:
// every box has the same swizzle) and divided by P for mean.  Rounded
// once to bf16, that combined tile put ~1% of the outputs past the 2e-2
// tolerance where the output is near 0 (2^-9 relative per term over k
// 64; measured on the card), so it is carried as two bf16 terms, hi =
// bf16(v) into the first owner's box and lo = bf16(v - hi) into the
// second's (~2^-17 relative), and each k step runs its wgmma twice, hi
// then lo (one owner's sum is exact in bf16: no lo).  Fixed k order, no
// split-K: equal inputs give equal bits, and a row's bits do not depend
// on T.
// The epilogue rounds the f32 accumulators to bf16.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

enum Combine { kConcat = 0, kSum = 1, kMean = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Waits until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// --- fma route ---------------------------------------------------------------

// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a (rows, cols)
// row-major array into a shared f32 tile with row stride LD; past the
// edge zeros.  VEC: 16-byte cp.async (f32, cols and c0 multiples of 4).
template <typename T, int ROWS, int COLS, int LD, int NT, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int rows, int cols, int r0,
                                           int c0) {
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < ROWS * COLS / 4; i += NT) {
      const int r = i / (COLS / 4), c = (i % (COLS / 4)) * 4;
      const bool ok = r0 + r < rows && c0 + c < cols;
      cp_async16(smem_u32(dst + r * LD + c),
                 ok ? src + (long long)(r0 + r) * cols + c0 + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LD + c] = (r0 + r < rows && c0 + c < cols)
                            ? to_f32(src[(long long)(r0 + r) * cols + c0 + c])
                            : 0.0f;
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN, int BK, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    cut_fusion_fma(const T* __restrict__ z, const T* __restrict__ w,
                   T* __restrict__ out, int P, int Tn, int K, int D,
                   int combine, int stages) {
  constexpr int NTX = BN / TN, NTY = BM / TM, NT = NTX * NTY;
  constexpr int LDZ = BK + 4;                 // padded z row, floats
  constexpr int ZF = BM * LDZ, WF = BK * BN;  // floats per z and w tile
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  // the tile column of a thread's j-th output: runs of 4 (16-byte loads
  // of the w tile) when TN allows, else every NTX-th
  auto col = [](int tx, int j) {
    return TN % 4 == 0 ? (j / 4) * NTX * 4 + tx * 4 + j % 4 : tx + j * NTX;
  };
  const int nd = (D + BN - 1) / BN;
  const int t0 = (blockIdx.x / nd) * BM, d0 = (blockIdx.x % nd) * BN;
  const bool concat = combine == kConcat;
  const int nz = concat ? 1 : P;
  const int kc = (K + BK - 1) / BK;           // k chunks per owner
  const int n = concat ? P * kc : kc;         // ring steps, (p, k) order
  const int stage_f = nz * ZF + WF;
  const long long zplane = (long long)Tn * K;

  auto issue = [&](int step) {
    float* st = smem + (step % stages) * stage_f;
    const int p = concat ? step / kc : 0, k0 = (step % kc) * BK;
    for (int q = 0; q < nz; ++q)
      stage_tile<T, BM, BK, LDZ, NT, VEC>(
          st + q * ZF, z + (concat ? p : q) * zplane, Tn, K, t0, k0);
    stage_tile<T, BK, BN, BN, NT, VEC>(st + nz * ZF,
                                       w + (long long)p * K * D, K, D, k0,
                                       d0);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < n) issue(s);
    cp_async_commit();
  }
  for (int step = 0; step < n; ++step) {
    if (step + stages - 1 < n) issue(step + stages - 1);
    cp_async_commit();
    cp_async_wait_n(stages - 1);     // this step's chunk has landed
    __syncthreads();
    float* zs = smem + (step % stages) * stage_f;
    const float* ws = zs + nz * ZF;
    if (!concat) {                   // the owners added in f32, in order
      for (int i = tid; i < BM * BK; i += NT) {
        const int at = (i / BK) * LDZ + i % BK;
        float v = 0.0f;
        for (int q = 0; q < P; ++q) v += zs[q * ZF + at];
        if (combine == kMean) v = __fdiv_rn(v, (float)P);
        zs[at] = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(zs + (ty + i * NTY) * LDZ +
                                                kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float b[TN];
        if constexpr (TN % 4 == 0) {     // 16-byte loads of 4 columns
#pragma unroll
          for (int j4 = 0; j4 < TN / 4; ++j4) {
            const float4 v = *reinterpret_cast<const float4*>(
                ws + (kk + u) * BN + col(tx, 4 * j4));
            b[4 * j4] = v.x;
            b[4 * j4 + 1] = v.y;
            b[4 * j4 + 2] = v.z;
            b[4 * j4 + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = ws[(kk + u) * BN + col(tx, j)];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y
                         : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();                 // the stage is free for step + stages
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty + i * NTY;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = d0 + col(tx, j);
      if (d < D) store(out + (long long)t * D + d, acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN, int BK>
int smem_fma(int P, int combine, int stages) {
  const int nz = combine == kConcat ? 1 : P;
  return (int)sizeof(float) * stages * (nz * BM * (BK + 4) + BK * BN);
}

template <typename T, int BM, int BN, int TM, int TN, int BK, bool VEC>
int launch_fma(const void* z, const void* w, void* out, int P, int Tn, int K,
               int D, int combine, int stages, cudaStream_t stream) {
  auto kernel = cut_fusion_fma<T, BM, BN, TM, TN, BK, VEC>;
  const int smem = smem_fma<BM, BN, TM, TN, BK>(P, combine, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((Tn + BM - 1) / BM) * ((D + BN - 1) / BN);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, (BM / TM) * (BN / TN), smem, stream>>>(
      (const T*)z, (const T*)w, (T*)out, P, Tn, K, D, combine, stages);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_tile(int tile, const void* z, const void* w, void* out, int P,
                int Tn, int K, int D, int combine, int stages,
                cudaStream_t s) {
  // the tile codes of kernels/cut_fusion/plan.py::TILES, in order
  switch (tile) {
    case 0: return launch_fma<T, 128, 128, 8, 8, 16, VEC>(z, w, out, P, Tn,
                                                          K, D, combine,
                                                          stages, s);
    case 1: return launch_fma<T, 64, 64, 4, 4, 32, VEC>(z, w, out, P, Tn, K,
                                                        D, combine, stages,
                                                        s);
    case 2: return launch_fma<T, 32, 32, 2, 2, 32, VEC>(z, w, out, P, Tn, K,
                                                        D, combine, stages,
                                                        s);
    case 3: return launch_fma<T, 16, 32, 2, 2, 32, VEC>(z, w, out, P, Tn, K,
                                                        D, combine, stages,
                                                        s);
  }
  return (int)cudaErrorInvalidValue;
}

// --- tc route ----------------------------------------------------------------

constexpr int kTcM = 128, kTcN = 128, kTcK = 64;
constexpr int kABytes = kTcM * kTcK * 2;    // one owner's z box
constexpr int kWBox = kTcK * 64 * 2;        // a 64 x 64 w box
constexpr int kWBytes = 2 * kWBox;          // the w tile: 2 boxes along d

#define D8(b)                                                            \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),            \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define R64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (64 x 128) += A (64 x 16, smem, K-major) . B (16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_n128_tb(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(128, 1)
    cut_fusion_tc(const __grid_constant__ CUtensorMap tz,
                  const __grid_constant__ CUtensorMap tw, bf16* out, int P,
                  int Tn, int K, int D, int combine, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const bool concat = combine == kConcat;
  const int nz = concat ? 1 : P;
  const int stage_b = nz * kABytes + kWBytes;
  const uint32_t bars = base + stages * stage_b;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nd = (D + kTcN - 1) / kTcN;
  const int t0 = (blockIdx.x / nd) * kTcM, d0 = (blockIdx.x % nd) * kTcN;
  const int kc = (K + kTcK - 1) / kTcK;
  const int n = concat ? P * kc : kc;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int step) {       // thread 0 only
    const int s = step % stages;
    const uint32_t st = base + s * stage_b, bar = bars + 8 * s;
    const int p = concat ? step / kc : 0, k0 = (step % kc) * kTcK;
    mbar_expect_tx(bar, stage_b);
    for (int q = 0; q < nz; ++q)
      tma_load3(st + q * kABytes, &tz, bar, k0, t0, concat ? p : q);
    for (int c = 0; c < 2; ++c)
      tma_load3(st + nz * kABytes + c * kWBox, &tw, bar, d0 + 64 * c, k0, p);
  };
  if (tid == 0)
    for (int s = 0; s < stages && s < n; ++s) issue(s);

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;

  for (int step = 0; step < n; ++step) {
    const int s = step % stages;
    const uint32_t st = base + s * stage_b;
    mbar_wait(bars + 8 * s, (step / stages) & 1);
    if (!concat) {
      // the owners' boxes added in f32 in owner order, / P for mean, as
      // hi + lo bf16 into the first two boxes (same swizzle in all)
      uint8_t* gen = smem_raw + (st - smem_u32(smem_raw));
      for (int i = tid; i < kABytes / 4; i += 128) {
        float x = 0.0f, y = 0.0f;
        for (int q = 0; q < P; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(gen + q * kABytes +
                                                       4 * i));
          x += f.x;
          y += f.y;
        }
        if (combine == kMean) {
          x = __fdiv_rn(x, (float)P);
          y = __fdiv_rn(y, (float)P);
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(gen + 4 * i) = hi;
        if (P > 1)
          *reinterpret_cast<uint32_t*>(gen + kABytes + 4 * i) =
              pack_bf16(x - hf.x, y - hf.y);
      }
      fence_proxy_async();           // generic writes -> wgmma's reads
      __syncthreads();
    }
    const uint32_t sA = st, sW = st + nz * kABytes;
    const bool lo = !concat && P > 1;   // the combine's lo terms
    wg_fence();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint64_t db = desc(sW + kk * 16 * 128, kWBox / 16, 64);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wgmma_n128_tb(acc[h], desc(sA + h * 64 * 128 + kk * 32, 1, 64), db);
        if (lo)
          wgmma_n128_tb(acc[h],
                        desc(sA + kABytes + h * 64 * 128 + kk * 32, 1, 64),
                        db);
      }
    }
    wg_commit();
    wg_wait();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    __syncthreads();                 // every warp is done with stage s
    if (tid == 0 && step + stages < n) issue(step + stages);
  }

  // acc[h][i]: row t0 + 64 h + 16 warp + lane / 4 + 8 ((i >> 1) & 1),
  // column d0 + 8 (i >> 2) + 2 (lane % 4) + (i & 1); d % 8 == 0, so a
  // column pair is whole
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int t = t0 + 64 * h + 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int d = d0 + 8 * (i >> 2) + 2 * (lane & 3);
      if (t < Tn && d < D)
        *reinterpret_cast<uint32_t*>(out + (long long)t * D + d) =
            pack_bf16(acc[h][i], acc[h][i + 1]);
    }
}

int launch_tc(const void* z, const void* w, void* out, int P, int Pw, int Tn,
              int K, int D, int combine, int stages, cudaStream_t stream) {
  CUtensorMap tz, tw;
  const cuuint64_t zd[3] = {(cuuint64_t)K, (cuuint64_t)Tn, (cuuint64_t)P};
  const cuuint64_t zs[2] = {(cuuint64_t)K * 2, (cuuint64_t)Tn * K * 2};
  const cuuint32_t zb[3] = {kTcK, kTcM, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Pw};
  const cuuint64_t ws[2] = {(cuuint64_t)D * 2, (cuuint64_t)K * D * 2};
  const cuuint32_t wb[3] = {64, kTcK, 1};
  if (!encode_bf16(&tz, z, 3, zd, zs, zb) ||
      !encode_bf16(&tw, w, 3, wd, ws, wb))
    return -1;
  const int nz = combine == kConcat ? 1 : P;
  const int smem = stages * (nz * kABytes + kWBytes) + 8 * stages + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      cut_fusion_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((Tn + kTcM - 1) / kTcM) * ((D + kTcN - 1) / kTcN);
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cut_fusion_tc<<<(unsigned)blocks, 128, smem, stream>>>(
      tz, tw, (bf16*)out, P, Tn, K, D, combine, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted), or -1 when a tensor map could not be encoded.  z
// (P, T, K) and w (Pw, K, D) are contiguous device arrays of one type
// (dtype 0: f32, 1: bf16); w's first block row is the only one read for
// sum (combine 1) and mean (combine 2).  route 0 = fma with `tile` (a
// code of plan.py::TILES), `stages` ring stages and `vec` (16-byte
// cp.async: f32, K and D multiples of 4, aligned pointers); route 1 =
// tc (bf16, K and D multiples of 8, 16-byte aligned pointers) with
// `stages`.  T == 0 or D == 0 launches nothing; K == 0 writes zeros.
extern "C" int cut_fusion_launch(const void* z, const void* w, void* out,
                                 int dtype, int P, int Pw, int T, int K, int D,
                                 int combine, int route, int tile, int stages,
                                 int vec, void* stream) {
  if (T == 0 || D == 0) return (int)cudaGetLastError();
  if (combine < kConcat || combine > kMean || P < 1 || stages < 1 ||
      stages > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1 || K % 8 || D % 8 || K == 0)
      return (int)cudaErrorInvalidValue;
    return launch_tc(z, w, out, P, Pw, T, K, D, combine, stages, s);
  }
  if (dtype == 0 && vec)
    return launch_tile<float, true>(tile, z, w, out, P, T, K, D, combine,
                                    stages, s);
  if (dtype == 0)
    return launch_tile<float, false>(tile, z, w, out, P, T, K, D, combine,
                                     stages, s);
  if (dtype == 1)
    return launch_tile<bf16, false>(tile, z, w, out, P, T, K, D, combine,
                                    stages, s);
  return (int)cudaErrorInvalidValue;
}
