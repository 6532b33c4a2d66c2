// Chunk-parallel SSD (Mamba2) scan on Hopper's tensor cores (sm_90a):
// bf16 x, B, C with d_state N and head dim P multiples of 16 up to 64,
// every prefill scan of zamba2-2.7b.  Built by repro_torch/kernels/
// build.py with nvcc into a shared library with a plain C interface,
// bound with ctypes (repro_torch/kernels/mamba2_scan/ops.py, route
// "chunked"; f32 calls and other shapes take csrc/mamba2_scan.cu).
//
// Replaces, for these calls, the Pallas TPU kernel
//   repro/kernels/mamba2_scan/kernel.py::_ssd_kernel (ssd_scan_raw)
// and computes what the reference's oracle repro/models/ssm.py::
// ssd_chunked computes, for x (B, S, H, P), dt (B, S, H) f32, A (H,)
// f32 and B, C (B, S, G, N) read in place through their strides; head h
// reads group h / (H / G).  Chunks of L rows, cum_i the inclusive prefix
// sum of dt A inside a chunk, cum_L its last entry.
//
// What bounds it: at zamba2's prefill shapes (L = 256, N = P = 64) the
// scan does ~49 flops per byte of its inputs and outputs, below the
// card's bf16 ridge: bytes, at a perfect kernel.  PR 13's design
// (csrc/mamba2_scan.cu) walks the chunks in order in one 256-thread block
// per (batch, head) on f32 FMAs: 320 blocks at the trunk prefill, the
// chunk walk serial, ~13 TFLOP/s.  This design removes the serial walk
// from everything but an elementwise pass, and moves the products to
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators), in three launches on one stream:
//
//   (a) ssd_chunk_state, one block per (chunk, batch x head): the
//       prefix sum of dt A over the chunk, then
//         s_c = sum_j exp(cum_L - cum_j) dt_j B_j^T x_j      (N x P, f32)
//       as a product with K = L; it writes s_c and cum_L ("total").
//   (b) ssd_state_pass, elementwise over (batch x head, N x P),
//       sequential over the chunks only:
//         S_c = exp(total_c) S_{c-1} + s_c,  S_{-1} = initial_state
//       writing each chunk's incoming state S_{c-1} (as bf16 hi and lo
//       planes) and the final state.
//   (c) ssd_chunk_out, one block per (64-row i tile, chunk, batch x
//       head), heavier i tiles first:
//         y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i S_{c-1}
//       j tiles above the diagonal skipped, the mask applied before the
//       exp (j > i would overflow), the decay exp(cum_i - cum_j) by the
//       SFU's ex2.approx (an accurate expf per score took a quarter of
//       the kernel's time), the next j tile's B and x loaded by cp.async
//       while the current one is multiplied.
//
// Rounding: three f32 operands feed the bf16 products: (1) B_j
// exp(cum_L - cum_j) dt_j in (a); (2) the incoming state S_{c-1} in (c);
// (3) the masked, decayed scores M_ij in (c).  Rounded to bf16 once each
// (as P is in attention's tc route), they put a few outputs of zamba2's
// prefill past the 2e-2 tolerance where y is near 0 (about 2^-9 relative
// per term over 256 terms of |M x| ~ 0.4; measured on the card).  So each
// is carried as two bf16 terms, hi = bf16(v) and lo = bf16(v - hi)
// (~2^-17 relative), and its product runs twice, hi then lo, into the
// same f32 accumulators.  x, B and C are bf16 inputs, used as they are.
// Every sum is f32, in a fixed order; no atomics, so equal inputs give
// equal bits.
//
// Bytes: the chunk states add B x H x (S / L) x N x P x 4 bytes twice:
// s_c in f32 (written by (a), read by (b)) and S_{c-1} as hi and lo
// (written by (b), read by every i tile of (c)): ~21 MB each at the trunk
// prefill (4 x 80 x 4 chunks x 16 KB), beside ~42 MB each of bf16 x
// (read by (a) and by (c)) and y; the bound (chip_smoke.py::scan_bound)
// counts the inputs and outputs once.  Tiles are padded to N = P = 64 in
// shared memory (zeros), rows past the sequence are zeros, so every
// product is whole.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;      // 4 warps
constexpr int kT = 64;             // rows of a tile, and N, P padded
constexpr int kLd = kT + 8;        // bf16 row stride of a shared tile
constexpr int kTileBytes = kT * kLd * 2;

struct Params {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const float* init;               // (Bb, H, N, P) f32, or null for zeros
  bf16* y;                         // (Bb, S, H, P) contiguous
  float* states;                   // (Bb, H, nc, N, P): s_c
  bf16* incoming;                  // (Bb, H, nc, 2, N, P): S_{c-1} hi, lo
  float* totals;                   // (Bb, H, nc): cum_L of each chunk
  float* final_state;              // (Bb, H, N, P)
  int S, H, P, G, N, L, nc;
  long long xs_b, xs_s, xs_h;      // element strides
  long long ds_b, ds_s, ds_h;
  long long bs_b, bs_s, bs_g;
  long long cs_b, cs_s, cs_g;
};

// e^x by the SFU: 2^(x log2 e) with ex2.approx (about 2 ulp, far inside
// the bf16 tolerance; x <= 0 here, and a masked entry is never taken).
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// v as hi + lo, two bf16 pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// dt (0 past `live`) and the inclusive prefix sum of dt A over the first
// n_rows rows of a chunk, 128 rows at a time (a warp scan, then the
// warps' totals in order): the same bits in (a) and (c) for every row
// both compute.
__device__ __forceinline__ void chunk_prefix(float* sCum, float* sDt,
                                             float* sWarp, const float* DT,
                                             long long ds_s, float A,
                                             int live, int n_rows) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.0f;
  for (int base = 0; base < n_rows; base += kThreads) {
    const int r = base + tid;
    const float d = r < live ? DT[(long long)r * ds_s] : 0.0f;
    float v = d * A;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    __syncthreads();               // sWarp is free
    if (lane == 31) sWarp[warp] = v;
    __syncthreads();
    float pre = carry, tot = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) pre += sWarp[w];
      tot += sWarp[w];
    }
    if (r < n_rows) {
      sDt[r] = d;
      sCum[r] = pre + v;
    }
    carry += tot;
  }
  __syncthreads();
}

// Rows [r0, r0 + 64) of a (rows, width) bf16 slice into a 64 x 64 shared
// tile by cp.async, 16 bytes at a time; rows at or past `live` and
// columns at or past `width` (a multiple of 8) are zeros.
__device__ __forceinline__ void tile_async(uint32_t dst, const bf16* src,
                                           long long row_stride, int r0,
                                           int live, int width) {
  for (int i = threadIdx.x; i < kT * (kT / 8); i += kThreads) {
    const int r = i / (kT / 8), c = (i % (kT / 8)) * 8;
    const bool ok = r0 + r < live && c < width;
    cp_async16(dst + (r * kLd + c) * 2,
               ok ? src + (long long)(r0 + r) * row_stride + c : src,
               ok ? 16 : 0);
  }
}

// A fragment (16 x 16) of rows m0.. and columns k0.. of a row-major
// shared tile [m][k].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile,
                                       int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, tile + ((m0 + ((l >> 3) & 1) * 8 + (l & 7)) * kLd + k0 +
                     (l >> 4) * 8) * 2);
}
// A fragment (16 x 16) of A = T^T for a shared tile T stored [k][m].
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], uint32_t tile,
                                         int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(a, tile + ((k0 + (l >> 4) * 8 + (l & 7)) * kLd + m0 +
                           ((l >> 3) & 1) * 8) * 2);
}
// B fragments (16 x 8) of the column tiles n0.. and n0 + 8.. for a
// shared tile stored [k][n] (b[0], b[1] for n0; b[2], b[3] for n0 + 8).
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], uint32_t tile,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + ((k0 + ((l >> 3) & 1) * 8 + (l & 7)) * kLd + n0 +
                           (l >> 4) * 8) * 2);
}
// The same for a shared tile stored [n][k].
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], uint32_t tile,
                                          int k0, int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, tile + ((n0 + (l >> 4) * 8 + (l & 7)) * kLd + k0 +
                     ((l >> 3) & 1) * 8) * 2);
}

// (a) one block per (chunk, batch x head); warp w computes rows
// [16 w, 16 w + 16) of s_c (n) over all 64 (padded) columns p.  B and x
// come in 64-row tiles through a two-stage cp.async ring (the first
// tile's loads in flight during the prefix sums); each B tile is scaled
// and split into hi and lo in shared memory before its products.
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t tB = base, tBl = base + kTileBytes;   // scaled B: hi, lo
  const uint32_t tR0 = base + 2 * kTileBytes;          // raw B [2][j][n]
  const uint32_t tX0 = base + 4 * kTileBytes;          // x [2][j][p]
  bf16* sB = reinterpret_cast<bf16*>(smem);
  bf16* sBl = reinterpret_cast<bf16*>(smem + kTileBytes);
  float* sCum = reinterpret_cast<float*>(smem + 6 * kTileBytes);
  float* sDt = sCum + p.L;
  __shared__ float sWarp[kThreads / 32];

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = c * p.L, live = min(p.L, p.S - row0);
  const int nj = (live + kT - 1) / kT;
  const bf16* X = p.x + b * p.xs_b + h * p.xs_h + (long long)row0 * p.xs_s;
  const bf16* Bm = p.B + b * p.bs_b + g * p.bs_g + (long long)row0 * p.bs_s;
  tile_async(tR0, Bm, p.bs_s, 0, live, p.N);
  tile_async(tX0, X, p.xs_s, 0, live, p.P);
  cp_async_commit();
  chunk_prefix(sCum, sDt, sWarp, p.dt + b * p.ds_b + h * p.ds_h +
                                     (long long)row0 * p.ds_s,
               p.ds_s, p.A[h], live, p.L);
  const float total = sCum[p.L - 1];
  if (tid == 0) p.totals[(long long)bh * p.nc + c] = total;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int t = 0; t < nj; ++t) {
    const int j0 = t * kT;
    if (t + 1 < nj) {              // the next tile, into the other buffer
      const uint32_t nb = ((t + 1) & 1) * kTileBytes;
      tile_async(tR0 + nb, Bm, p.bs_s, j0 + kT, live, p.N);
      tile_async(tX0 + nb, X, p.xs_s, j0 + kT, live, p.P);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // B_j exp(cum_L - cum_j) dt_j as hi + lo bf16 (operand 1), 8 columns
    // at a time
    const bf16* raw = reinterpret_cast<const bf16*>(
        smem + 2 * kTileBytes + (t & 1) * kTileBytes);
    for (int i = tid; i < kT * (kT / 8); i += kThreads) {
      const int r = i / (kT / 8), col = (i % (kT / 8)) * 8, j = j0 + r;
      const float w = j < live ? expf(total - sCum[j]) * sDt[j] : 0.0f;
      const uint4 rv = *reinterpret_cast<const uint4*>(raw + r * kLd + col);
      const uint32_t in[4] = {rv.x, rv.y, rv.z, rv.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&in[e]));
        split_bf16(f.x * w, f.y * w, hi[e], lo[e]);
      }
      *reinterpret_cast<uint4*>(sB + r * kLd + col) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sBl + r * kLd + col) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    const uint32_t tX = tX0 + (t & 1) * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4], al[4];
      frag_a_t(a, tB, 16 * warp, 16 * kk);          // A[n][j] = sB[j][n]
      frag_a_t(al, tBl, 16 * warp, 16 * kk);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bb[4];
        frag_b_kn(bb, tX, 16 * kk, 8 * nt);         // B[j][p] = sX[j][p]
        mma_bf16(acc[nt], a, bb[0], bb[1]);
        mma_bf16(acc[nt], al, bb[0], bb[1]);
        mma_bf16(acc[nt + 1], a, bb[2], bb[3]);
        mma_bf16(acc[nt + 1], al, bb[2], bb[3]);
      }
    }
    __syncthreads();               // both buffers of tile t are free
  }

  // acc[nt][e]: row n = 16 warp + lane / 4 + 8 (e >> 1), column
  // p = 8 nt + 2 (lane % 4) + (e & 1)
  float* out = p.states + ((long long)bh * p.nc + c) * p.N * p.P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * (lane & 3);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = 16 * warp + (lane >> 2) + 8 * hf;
      if (n < p.N && col < p.P)
        *reinterpret_cast<float2*>(out + n * p.P + col) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
}

// (b) four consecutive (n, p) entries of one (batch, head) per thread,
// the chunks in order; the loads of up to 8 chunks are issued before
// their chain of FMAs, so one memory latency covers them.  Each chunk's
// incoming state is written as bf16 hi and lo planes, the form (c)
// multiplies, so (c) copies it with cp.async.
__global__ void __launch_bounds__(kThreads) ssd_state_pass(Params p) {
  constexpr int kBatch = 8;
  const int bh = blockIdx.y;
  const int np = p.N * p.P;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= np) return;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (p.init != nullptr)
    s = *reinterpret_cast<const float4*>(p.init + (long long)bh * np + e);
  const float4* st = reinterpret_cast<const float4*>(
      p.states + (long long)bh * p.nc * np + e);
  const float* tot = p.totals + (long long)bh * p.nc;
  for (int c0 = 0; c0 < p.nc; c0 += kBatch) {
    float4 sc[kBatch];
    float et[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.nc) {
        sc[k] = st[(long long)(c0 + k) * (np / 4)];
        et[k] = expf(tot[c0 + k]);
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.nc) {
        // the chunk's incoming state as hi and lo planes (operand 2)
        bf16* in = p.incoming + ((long long)bh * p.nc + c0 + k) * 2 * np + e;
        uint32_t h0, l0, h1, l1;
        split_bf16(s.x, s.y, h0, l0);
        split_bf16(s.z, s.w, h1, l1);
        *reinterpret_cast<uint2*>(in) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(in + np) = make_uint2(l0, l1);
        s = make_float4(fmaf(et[k], s.x, sc[k].x), fmaf(et[k], s.y, sc[k].y),
                        fmaf(et[k], s.z, sc[k].z), fmaf(et[k], s.w, sc[k].w));
      }
  }
  *reinterpret_cast<float4*>(p.final_state + (long long)bh * np + e) = s;
}

// (c) one block per (i tile, chunk, batch x head); warp w owns rows
// [16 w, 16 w + 16) of the 64-row i tile.
__global__ void __launch_bounds__(kThreads) ssd_chunk_out(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t tC = base, tS = base + kTileBytes;   // S: hi, then lo
  const uint32_t tSl = base + 2 * kTileBytes;
  const uint32_t tB0 = base + 3 * kTileBytes;          // [2][j][n]
  const uint32_t tX0 = base + 5 * kTileBytes;          // [2][j][p]
  float* sCum = reinterpret_cast<float*>(smem + 7 * kTileBytes);
  float* sDt = sCum + p.L;
  __shared__ float sWarp[kThreads / 32];

  const int nit = (p.L + kT - 1) / kT;
  const int I = nit - 1 - (int)(blockIdx.x % nit);     // heavier tiles first
  const int c = blockIdx.x / nit, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = c * p.L, live = min(p.L, p.S - row0);
  const int i0 = I * kT;
  if (i0 >= live) return;          // the whole tile is past the sequence
  const int i_end = min(i0 + kT, live);
  const bf16* X = p.x + b * p.xs_b + h * p.xs_h + (long long)row0 * p.xs_s;
  const bf16* Bm = p.B + b * p.bs_b + g * p.bs_g + (long long)row0 * p.bs_s;
  const bf16* Cm = p.C + b * p.cs_b + g * p.cs_g + (long long)row0 * p.cs_s;

  // C of the i tile, the incoming state's hi and lo planes and the first
  // j tile's B and x, in flight while the prefix sums are computed
  const bf16* Sin = p.incoming + ((long long)bh * p.nc + c) * 2 * p.N * p.P;
  tile_async(tC, Cm, p.cs_s, i0, live, p.N);
  tile_async(tS, Sin, p.P, 0, p.N, p.P);
  tile_async(tSl, Sin + p.N * p.P, p.P, 0, p.N, p.P);
  tile_async(tB0, Bm, p.bs_s, 0, live, p.N);
  tile_async(tX0, X, p.xs_s, 0, live, p.P);
  cp_async_commit();
  chunk_prefix(sCum, sDt, sWarp, p.dt + b * p.ds_b + h * p.ds_h +
                                     (long long)row0 * p.ds_s,
               p.ds_s, p.A[h], live, i_end);

  const int m0 = 16 * warp;
  const int r0 = i0 + m0 + (lane >> 2), r1 = r0 + 8;   // this thread's rows
  float acc[8][4], inter[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = inter[i][e] = 0.0f;

  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kT;
    if (J < I) {                   // the next j tile, into the other buffer
      const int nb = (J + 1) & 1;
      tile_async(tB0 + nb * kTileBytes, Bm, p.bs_s, j0 + kT, live, p.N);
      tile_async(tX0 + nb * kTileBytes, X, p.xs_s, j0 + kT, live, p.P);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t tB = tB0 + (J & 1) * kTileBytes;
    const uint32_t tX = tX0 + (J & 1) * kTileBytes;

    uint32_t ca[4][4];             // C fragments of this warp's rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag_a(ca[kk], tC, m0, 16 * kk);
    if (J == 0) {                  // inter-chunk term: C_i . S_{c-1}
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          uint32_t bb[4], bl[4];
          frag_b_kn(bb, tS, 16 * kk, 8 * nt);       // B[n][p] = sS[n][p]
          frag_b_kn(bl, tSl, 16 * kk, 8 * nt);
          mma_bf16(inter[nt], ca[kk], bb[0], bb[1]);
          mma_bf16(inter[nt], ca[kk], bl[0], bl[1]);
          mma_bf16(inter[nt + 1], ca[kk], bb[2], bb[3]);
          mma_bf16(inter[nt + 1], ca[kk], bl[2], bl[3]);
        }
    }

    // scores C_i . B_j over n, 16 rows x 64 keys per warp
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jt = 0; jt < 8; jt += 2) {
        uint32_t bb[4];
        frag_b_nk(bb, tB, 16 * kk, 8 * jt);         // B[n][j] = sB[j][n]
        mma_bf16(sc[jt], ca[kk], bb[0], bb[1]);
        mma_bf16(sc[jt + 1], ca[kk], bb[2], bb[3]);
      }
    // M = scores x exp(cum_i - cum_j) x dt_j for j <= i (masked before
    // the exp), as hi + lo bf16 A fragments of M . x (operand 3):
    // sc[jt][e] is row r0 + 8 (e >> 1), key j0 + 8 jt + 2 (lane % 4) +
    // (e & 1), and the accumulator tiles 2 kk, 2 kk + 1 are the A
    // fragment of k-step kk
    uint32_t ma[4][4], ml[4][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e & 2) ? r1 : r0;
        const int j = j0 + 8 * jt + 2 * (lane & 3) + (e & 1);
        m[e] = (j <= i && i < i_end)
                   ? sc[jt][e] * fast_exp(sCum[i] - sCum[j]) * sDt[j]
                   : 0.0f;
      }
      split_bf16(m[0], m[1], ma[jt >> 1][(jt & 1) * 2],
                 ml[jt >> 1][(jt & 1) * 2]);
      split_bf16(m[2], m[3], ma[jt >> 1][(jt & 1) * 2 + 1],
                 ml[jt >> 1][(jt & 1) * 2 + 1]);
    }
    // y += M . x_j over the tile's keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bb[4];
        frag_b_kn(bb, tX, 16 * kk, 8 * nt);         // B[j][p] = sX[j][p]
        mma_bf16(acc[nt], ma[kk], bb[0], bb[1]);
        mma_bf16(acc[nt], ml[kk], bb[0], bb[1]);
        mma_bf16(acc[nt + 1], ma[kk], bb[2], bb[3]);
        mma_bf16(acc[nt + 1], ml[kk], bb[2], bb[3]);
      }
    __syncthreads();               // this buffer is free for tile J + 2
  }

  // y_i = intra + exp(cum_i) inter, in bf16; y is contiguous (Bb, S, H, P)
  const float e0 = r0 < i_end ? expf(sCum[r0]) : 0.0f;
  const float e1 = r1 < i_end ? expf(sCum[r1]) : 0.0f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * (lane & 3);
    if (col >= p.P) continue;
    if (r0 < i_end)
      *reinterpret_cast<uint32_t*>(
          p.y + (((long long)b * p.S + row0 + r0) * p.H + h) * p.P + col) =
          pack_bf16(acc[nt][0] + e0 * inter[nt][0],
                    acc[nt][1] + e0 * inter[nt][1]);
    if (r1 < i_end)
      *reinterpret_cast<uint32_t*>(
          p.y + (((long long)b * p.S + row0 + r1) * p.H + h) * p.P + col) =
          pack_bf16(acc[nt][2] + e1 * inter[nt][2],
                    acc[nt][3] + e1 * inter[nt][3]);
  }
}

int smem_state(int L) { return 6 * kTileBytes + 8 * L; }
int smem_out(int L) { return 7 * kTileBytes + 8 * L; }

}  // namespace

// Each stage launches on `stream` and returns the CUDA error code (0 when
// the launch was accepted).  x, B, C bf16 with the last dimension
// contiguous, 16-byte aligned rows and pointers; dt, A f32; strides in
// elements.  states (Bb, H, nc, N, P) f32, incoming (Bb, H, nc, 2, N, P)
// bf16, totals (Bb, H, nc), y
// (Bb, S, H, P), init and final_state (Bb, H, N, P) contiguous; init may
// be null (zeros).  The wrapper checks N, P multiples of 16 up to 64,
// H % G == 0, Bb * H <= 65535 and 1 <= L <= 8192.  stage 0 = (a), 1 =
// (b), 2 = (c); stage 3 runs all three in order.
extern "C" int mamba2_scan_chunked_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const float* init, void* y, float* states, void* incoming,
    float* totals, float* final_state, int Bb, int S, int H, int P, int G, int N, int L,
    long long xs_b, long long xs_s, long long xs_h, long long ds_b,
    long long ds_s, long long ds_h, long long bs_b, long long bs_s,
    long long bs_g, long long cs_b, long long cs_s, long long cs_g,
    int stage, void* stream) {
  if (Bb == 0 || H == 0 || S == 0) return (int)cudaGetLastError();
  const int nc = (S + L - 1) / L;
  Params p{static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(B),
           static_cast<const bf16*>(C), init, static_cast<bf16*>(y),
           states, static_cast<bf16*>(incoming), totals, final_state, S, H,
           P, G, N, L, nc,
           xs_b, xs_s, xs_h, ds_b, ds_s, ds_h, bs_b, bs_s, bs_g,
           cs_b, cs_s, cs_g};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (stage == 0 || stage == 3) {
    err = cudaFuncSetAttribute(ssd_chunk_state,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_state(L));
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_state<<<dim3(nc, Bb * H), kThreads, smem_state(L), st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stage == 1 || stage == 3) {
    ssd_state_pass<<<dim3((N * P / 4 + kThreads - 1) / kThreads, Bb * H),
                     kThreads, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stage == 2 || stage == 3) {
    err = cudaFuncSetAttribute(ssd_chunk_out,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_out(L));
    if (err != cudaSuccess) return (int)err;
    const int nit = (L + kT - 1) / kT;
    ssd_chunk_out<<<dim3(nit * nc, Bb * H), kThreads, smem_out(L), st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
