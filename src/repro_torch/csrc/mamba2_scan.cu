// Chunked SSD (Mamba2) scan for Hopper (sm_90a), f32 or bf16 inputs.
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, bound with ctypes
// (repro_torch/kernels/mamba2_scan/ops.py).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/mamba2_scan/kernel.py::_ssd_kernel
//   (ssd_scan_raw, wrapped by mamba2_scan/ops.py)
// and computes what the reference's oracle repro/models/ssm.py::ssd_chunked
// computes, for x (B, S, H, P), dt (B, S, H) f32, A (H,) f32 and B, C
// (B, S, G, N) read in place through their strides (slices of the Mamba2
// block's conv output need no copy and no transpose).  Head h reads group
// h / (H / G).  With chunks of L = min(chunk, S) rows, chunk by chunk:
//   cum_i   = sum_{k <= i} dt_k A             (inclusive, in the chunk)
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i S
//   S      <- exp(cum_L) S + sum_j exp(cum_L - cum_j) dt_j B_j^T x_j
// starting from S = initial_state (zeros when the pointer is null), with y
// stored in x's type and the final S (B, H, N, P) in f32.  Rows past the
// end of the sequence in the last chunk are masked (dt = x = B = C = 0),
// which is what the reference's zero padding gives: they leave S as it is.
// Everything is f32 on the CUDA cores; the prefix sum runs in another
// order than XLA's cumsum, so results agree to rounding, not bit for bit.
//
// Design: one block of 256 threads per (batch, head); the block loops over
// the chunks in order and keeps the (N, P) state in shared memory, since
// blocks run in no order and nothing may be carried between them (the TPU
// kernel carries it across a sequential grid axis).  The (L, L) decay
// matrix of a chunk of 256 does not fit in shared memory, so the chunk is
// cut into 64-row tiles: for each i tile, the inter-chunk term C_i S, then
// each j tile with j <= i (tiles wholly above the diagonal are skipped):
// the 64 x 64 scores C_i . B_j, masked (j <= i) BEFORE the exp, times the
// decay and dt_j, then times the x tile.  The last i tile visits every j
// tile, so the chunk's state contribution is accumulated there.  A thread
// owns a 4 x 4 block of every 64 x 64 product (rows ty*4.., columns tx +
// 16c); tiles are f32 in shared memory with rows padded by one float so
// that no two lanes of a warp hit one bank.  N and P up to 64 (zero
// padded).
//
// What bounds it: at the serving shapes (L = 256, N = P = 64) the work is
// about 49 flops per byte moved, below the card's bf16 ridge, so a kernel
// at the card's limit would be bound by bytes.  This design runs f32 FMAs
// on the CUDA cores (no tensor cores), walks the chunks one after another
// in 320 blocks at zamba2's trunk prefill (2.4 waves on 132 SMs), reloads
// the B and x tiles once per i tile (from L2) and computes whole diagonal
// tiles: it is bound by its FMA issue rate and the serial chunk walk, far
// from either limit (~13 TFLOP/s).  It is the `serial` route of
// mamba2_scan/ops.py: f32 calls (the 2e-4 tolerance rules out bf16
// operands) and widths or alignments the chunked route does not take.
// bf16 calls with N and P multiples of 16 up to 64 — every prefill scan of
// zamba2-2.7b — take csrc/mamba2_scan_chunked.cu, which runs the chunks in
// parallel on the tensor cores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;             // rows (and the N / P width) of a tile
constexpr int kTX = 16;            // threads along columns
constexpr int kTY = 16;            // threads along rows
constexpr int kThreads = kTX * kTY;
constexpr int kR = kT / kTY;       // rows per thread
constexpr int kC = kT / kTX;       // columns per thread
constexpr int kLd = kT + 1;        // padded row stride of a tile
constexpr int kTile = kT * kLd;    // floats in one tile

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* init;               // (Bb, H, N, P) f32, or null for zeros
  void* y;                         // (Bb, S, H, P) contiguous, x's type
  float* state;                    // (Bb, H, N, P) contiguous f32
  int S, H, P, G, N, L;
  long long xs_b, xs_s, xs_h;      // element strides
  long long ds_b, ds_s, ds_h;
  long long bs_b, bs_s, bs_g;
  long long cs_b, cs_s, cs_g;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [r0, r0 + 64) of a (rows, width) slice as f32 into a padded
// 64 x 64 shared tile; rows at or past `r_end` and columns at or past
// `width` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long row_stride, int r0,
                                      int r_end, int width) {
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, d = i % kT;
    float v = 0.0f;
    if (r0 + r < r_end && d < width)
      v = to_f32(src[(long long)(r0 + r) * row_stride + d]);
    dst[r * kLd + d] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan(Params p) {
  extern __shared__ float smem[];
  float* sS = smem;                // N x P: the carried state
  float* sC = sS + kTile;          // C rows of the i tile (i x n)
  float* sB = sC + kTile;          // B rows of the j tile (j x n)
  float* sX = sB + kTile;          // x rows of the j tile (j x p)
  float* sM = sX + kTile;          // masked, decayed scores (i x j)
  float* sCum = sM + kTile;        // L: the chunk's inclusive prefix sums
  float* sDt = sCum + p.L;         // L: dt, 0 on masked rows
  __shared__ float sWarp[kThreads / 32];

  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int g = h / (p.H / p.G);
  const T* X = static_cast<const T*>(p.x) + b * p.xs_b + h * p.xs_h;
  const T* Bm = static_cast<const T*>(p.B) + b * p.bs_b + g * p.bs_g;
  const T* Cm = static_cast<const T*>(p.C) + b * p.cs_b + g * p.cs_g;
  const float* DT = p.dt + b * p.ds_b + h * p.ds_h;
  const float A = p.A[h];
  const long long st0 = ((long long)b * p.H + h) * p.N * p.P;

  for (int i = tid; i < kT * kT; i += kThreads) {
    const int n = i / kT, q = i % kT;
    float v = 0.0f;
    if (p.init != nullptr && n < p.N && q < p.P)
      v = p.init[st0 + (long long)n * p.P + q];
    sS[n * kLd + q] = v;
  }

  const int L = p.L;
  const int nt = (L + kT - 1) / kT;
  const int nc = (p.S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int row0 = c * L;
    const int live = min(L, p.S - row0);   // rows of the chunk in the sequence
    const T* Xc = X + (long long)row0 * p.xs_s;
    const T* Bc = Bm + (long long)row0 * p.bs_s;
    const T* Cc = Cm + (long long)row0 * p.cs_s;

    // dt and the inclusive prefix sum of dt * A, 256 rows at a time
    float carry = 0.0f;
    for (int base = 0; base < L; base += kThreads) {
      const int r = base + tid;
      const float d = r < live ? DT[(long long)(row0 + r) * p.ds_s] : 0.0f;
      float v = d * A;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      __syncthreads();             // sWarp is free (and the last chunk's
                                   // readers of sCum, sDt, sS are done)
      if (lane == 31) sWarp[warp] = v;
      __syncthreads();
      float pre = carry, tot = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) {
        if (w < warp) pre += sWarp[w];
        tot += sWarp[w];
      }
      if (r < L) {
        sDt[r] = d;
        sCum[r] = pre + v;
      }
      carry += tot;
    }
    __syncthreads();
    const float total = sCum[L - 1];

    float accS[kR][kC];            // this chunk's state contribution
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int q = 0; q < kC; ++q) accS[r][q] = 0.0f;

    for (int I = 0; I < nt; ++I) {
      const int i0 = I * kT;
      __syncthreads();             // the last i tile is done with sC
      stage<T>(sC, Cc, p.cs_s, i0, live, p.N);
      __syncthreads();

      // inter-chunk term: acc = exp(cum_i) * (C_i . S)
      float acc[kR][kC];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < kC; ++q) acc[r][q] = 0.0f;
#pragma unroll 8
      for (int n = 0; n < kT; ++n) {
        float cv[kR], sv[kC];
#pragma unroll
        for (int r = 0; r < kR; ++r) cv[r] = sC[(ty * kR + r) * kLd + n];
#pragma unroll
        for (int q = 0; q < kC; ++q) sv[q] = sS[n * kLd + tx + q * kTX];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kC; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = i0 + ty * kR + r;
        const float e = i < L ? expf(sCum[i]) : 0.0f;
#pragma unroll
        for (int q = 0; q < kC; ++q) acc[r][q] *= e;
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * kT;
        __syncthreads();           // the last j tile is done with sB, sX, sM
        stage<T>(sB, Bc, p.bs_s, j0, live, p.N);
        stage<T>(sX, Xc, p.xs_s, j0, live, p.P);
        __syncthreads();

        // scores C_i . B_j, masked before the exp, times decay and dt_j
        float s[kR][kC];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int q = 0; q < kC; ++q) s[r][q] = 0.0f;
#pragma unroll 8
        for (int n = 0; n < kT; ++n) {
          float cv[kR], bv[kC];
#pragma unroll
          for (int r = 0; r < kR; ++r) cv[r] = sC[(ty * kR + r) * kLd + n];
#pragma unroll
          for (int q = 0; q < kC; ++q) bv[q] = sB[(tx + q * kTX) * kLd + n];
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int q = 0; q < kC; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = i0 + ty * kR + r;
#pragma unroll
          for (int q = 0; q < kC; ++q) {
            const int j = j0 + tx + q * kTX;
            float m = 0.0f;
            if (j <= i && i < L)
              m = s[r][q] * expf(sCum[i] - sCum[j]) * sDt[j];
            sM[(ty * kR + r) * kLd + tx + q * kTX] = m;
          }
        }
        __syncthreads();

        // intra-chunk term: acc += M (i x j) . x (j x p)
#pragma unroll 8
        for (int jj = 0; jj < kT; ++jj) {
          float mv[kR], xv[kC];
#pragma unroll
          for (int r = 0; r < kR; ++r) mv[r] = sM[(ty * kR + r) * kLd + jj];
#pragma unroll
          for (int q = 0; q < kC; ++q) xv[q] = sX[jj * kLd + tx + q * kTX];
#pragma unroll
          for (int r = 0; r < kR; ++r)
#pragma unroll
            for (int q = 0; q < kC; ++q) acc[r][q] = fmaf(mv[r], xv[q], acc[r][q]);
        }

        // the last i tile visits every j tile: the chunk's state
        // contribution sum_j exp(total - cum_j) dt_j B_j[n] x_j[p]
        if (I == nt - 1) {
          const int jn = min(kT, L - j0);
          for (int jj = 0; jj < jn; ++jj) {
            const int j = j0 + jj;
            const float w = expf(total - sCum[j]) * sDt[j];
            float bv[kR], xv[kC];
#pragma unroll
            for (int r = 0; r < kR; ++r) bv[r] = sB[jj * kLd + ty * kR + r] * w;
#pragma unroll
            for (int q = 0; q < kC; ++q) xv[q] = sX[jj * kLd + tx + q * kTX];
#pragma unroll
            for (int r = 0; r < kR; ++r)
#pragma unroll
              for (int q = 0; q < kC; ++q)
                accS[r][q] = fmaf(bv[r], xv[q], accS[r][q]);
          }
        }
      }

      // y rows of this i tile; y is contiguous (Bb, S, H, P)
      T* Y = static_cast<T*>(p.y);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = i0 + ty * kR + r;
        if (i >= live) continue;
        T* yrow = Y + (((long long)b * p.S + row0 + i) * p.H + h) * p.P;
#pragma unroll
        for (int q = 0; q < kC; ++q) {
          const int col = tx + q * kTX;
          if (col < p.P) store(yrow + col, acc[r][q]);
        }
      }
    }

    // S <- exp(total) S + the chunk's contribution (each thread updates
    // the entries it owns; every read of the old S is behind a barrier)
    __syncthreads();
    const float et = expf(total);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        float* e = &sS[(ty * kR + r) * kLd + tx + q * kTX];
        *e = fmaf(et, *e, accS[r][q]);
      }
  }

  __syncthreads();
  for (int i = tid; i < p.N * p.P; i += kThreads) {
    const int n = i / p.P, q = i % p.P;
    p.state[st0 + i] = sS[n * kLd + q];
  }
}

template <typename T>
int launch(const Params& p, int Bb, void* stream) {
  const int smem = (int)sizeof(float) * (5 * kTile + 2 * p.L);
  // above 48 KB a block's dynamic shared memory has to be allowed first
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan<T><<<Bb * p.H, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 when the launch
// was accepted).  dtype 0 = f32, 1 = bf16 (x, B, C and y share it; dt, A
// and the states are f32).  Strides are in elements; the last dimension of
// x, B and C is contiguous; init (may be null), y and state are
// contiguous.  The wrapper checks 1 <= N, P <= 64, H % G == 0 and
// 1 <= L <= 8192.
extern "C" int mamba2_scan_launch(
    const void* x, const float* dt, const float* A, const void* B,
    const void* C, const float* init, void* y, float* state, int dtype,
    int Bb, int S, int H, int P, int G, int N, int L, long long xs_b,
    long long xs_s, long long xs_h, long long ds_b, long long ds_s,
    long long ds_h, long long bs_b, long long bs_s, long long bs_g,
    long long cs_b, long long cs_s, long long cs_g, void* stream) {
  if (Bb == 0 || H == 0) return (int)cudaGetLastError();
  Params p{x, dt, A, B, C, init, y, state, S, H, P, G, N, L,
           xs_b, xs_s, xs_h, ds_b, ds_s, ds_h,
           bs_b, bs_s, bs_g, cs_b, cs_s, cs_g};
  if (dtype == 0) return launch<float>(p, Bb, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, Bb, stream);
  return (int)cudaErrorInvalidValue;
}
