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
// Design: one block of 16 x 16 threads per 64 x 64 output tile.  The
// contraction loop runs over (owner p, 32-wide k tile), the TPU grid's
// sequential P * K_tiles axis folded into one loop.  Each step stages
// the z tile (64 rows x 32, transposed, rows padded by one float so that
// the transposing stores hit 32 banks) and the w tile (32 x 64) in
// shared memory as f32, and each thread accumulates its 4 x 4 outputs
// (rows ty + 16 i, columns tx + 16 j) in f32 registers with FMAs.  bf16
// inputs are widened to f32 before the FMA.  No tensor cores, no TF32:
// the f32 tolerance of 2e-4 over K up to 512 rules TF32 out.  Ragged T,
// K and D are masked in the loads (zeros) and the stores; nothing is
// padded by a copy.
//
// Deterministic: every output is summed in one fixed order (p, then k)
// by one thread, with no atomics and no split-K, so equal inputs give
// equal bits on every call — what keeps split == joint training bitwise
// on the card.
//
// What bounds it: at the training path's shape (2, 128, 64) x
// (2, 64, 500) the work is 16.4 MFLOP against 0.58 MB, 0.25 us of f32
// FMAs at the card's peak: the launch costs far more, and 16 blocks
// leave most SMs idle.  At large T the f32 FMA rate bounds it (two FMAs
// per shared-memory load); tensor cores (wgmma on bf16 operands) and
// TMA are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;            // output rows (T) per block
constexpr int kBN = 64;            // output columns (D) per block
constexpr int kBK = 32;            // contraction depth per step
constexpr int kTX = 16;            // threads along D
constexpr int kTY = 16;            // threads along T
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBM / kTY;   // outputs per thread along T
constexpr int kCols = kBN / kTX;   // outputs per thread along D

enum Combine { kConcat = 0, kSum = 1, kMean = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cut_fusion_tile(const T* __restrict__ z, const T* __restrict__ w,
                T* __restrict__ out, int P, int Tn, int K, int D,
                int combine) {
  __shared__ float zs[kBK][kBM + 1];   // z tile, transposed: zs[k][t]
  __shared__ float ws[kBK][kBN];       // w tile: ws[k][d]
  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int t0 = blockIdx.y * kBM, d0 = blockIdx.x * kBN;
  const bool first_sum = combine != kConcat;
  const long long zplane = (long long)Tn * K;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const int passes = first_sum ? 1 : P;
  for (int p = 0; p < passes; ++p) {
    const T* wp = w + (long long)p * K * D;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      // z tile: 64 rows x 32, read along k (coalesced), stored transposed
#pragma unroll
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        const int t = t0 + r, k = k0 + c;
        float v = 0.0f;
        if (t < Tn && k < K) {
          const long long off = (long long)t * K + k;
          if (first_sum) {
            for (int q = 0; q < P; ++q) v += to_f32(z[q * zplane + off]);
            if (combine == kMean) v = __fdiv_rn(v, (float)P);
          } else {
            v = to_f32(z[p * zplane + off]);
          }
        }
        zs[c][r] = v;
      }
      // w tile: 32 x 64, read along d
#pragma unroll
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int r = e / kBN, c = e % kBN;
        const int k = k0 + r, d = d0 + c;
        ws[r][c] = (k < K && d < D) ? to_f32(wp[(long long)k * D + d])
                                    : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kRows], b[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) a[i] = zs[kk][ty + kTY * i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) b[j] = ws[kk][tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + ty + kTY * i;
    if (t >= Tn) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = d0 + tx + kTX * j;
      if (d < D) store(out + (long long)t * D + d, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* z, const void* w, void* out, int P, int Tn, int K,
           int D, int combine, void* stream) {
  dim3 grid((D + kBN - 1) / kBN, (Tn + kBM - 1) / kBM);
  cut_fusion_tile<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const T*)w, (T*)out, P, Tn, K, D, combine);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  z (P, T, K) and w (Pw, K, D) are contiguous device
// arrays of one type (dtype 0: f32, 1: bf16); w's first block row is
// the only one read for sum (combine 1) and mean (combine 2).  T == 0 or
// D == 0 launches nothing; K == 0 writes zeros.
extern "C" int cut_fusion_launch(const void* z, const void* w, void* out,
                                 int dtype, int P, int T, int K, int D,
                                 int combine, void* stream) {
  if (T == 0 || D == 0) return (int)cudaGetLastError();
  if (combine < kConcat || combine > kMean || P < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(z, w, out, P, T, K, D, combine,
                                       stream);
  if (dtype == 1) return launch<__nv_bfloat16>(z, w, out, P, T, K, D,
                                               combine, stream);
  return (int)cudaErrorInvalidValue;
}
