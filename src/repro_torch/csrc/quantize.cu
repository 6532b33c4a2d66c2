// Per-row symmetric int8 quantization of the cut payload, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes
// (repro_torch/kernels/quantize/ops.py).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/quantize/kernel.py::_quantize_pack_kernel  (quantize_pack_int8)
//   repro/kernels/quantize/kernel.py::_quantize_kernel       (quantize_int8)
// and computes exactly what they compute, per row of x (T, K) f32:
//   scale = max(absmax_row, 1e-12) / 127
//   q     = clip(round_half_even(x / scale), -127, 127)  as int8
// The packed entry writes the wire frame uint8 (T, K+4): K int8 bytes,
// then the 4 little-endian bytes of the f32 scale.  The unpacked entry
// writes q int8 (T, K) and scale f32 (T, 1).
//
// What bounds it: memory bytes.  It reads 4*T*K bytes and writes
// T*(K+4) (packed) or T*K + 4*T (unpacked), with a handful of
// operations per element.  At the training path's shape (128, 64) that
// is 32 KiB read and 8.5 KiB written: the launch costs more than the
// bytes, so the kernel is launch-bound there.  This first design does
// nothing yet about launch overhead (no fusion into the head's epilogue,
// no CUDA graph); it is one warp per row, simple and exact.
//
// Exactness, so that the bytes equal the plain version's and the
// reference's:
//   * true IEEE division x / scale (__fdiv_rn), never a multiply by a
//     reciprocal; the library is built without --use_fast_math;
//   * rintf rounds half to even, as jnp.round and torch.round do;
//   * NaN propagates, as in jnp.max: the row absmax is taken with a max
//     that keeps NaN (fmaxf would drop it), so a row holding NaN gets a
//     NaN scale and the receiver decodes NaN.  A value that quantizes to
//     NaN (NaN input, or inf / inf) is stored as 0 — the plain version
//     does the same, and so does XLA's float-to-int conversion;
//   * the frame's row stride is K+4 bytes, not 4-aligned for every K, so
//     the scale is written as four byte stores, never as a float store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;   // one warp per row, 8 warps per block

__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

template <bool kPack>
__global__ void quantize_rows(const float* __restrict__ x, int T, int K,
                              uint8_t* __restrict__ out,
                              float* __restrict__ scales) {
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= T) return;  // ragged last block: masked, not padded
  const float* xr = x + row * K;

  float m = 0.0f;
  for (int j = lane; j < K; j += 32) m = max_keep_nan(m, fabsf(xr[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = __fdiv_rn(isnan(m) ? m : fmaxf(m, 1e-12f), 127.0f);

  int8_t* q = kPack ? reinterpret_cast<int8_t*>(out + row * (K + 4))
                    : reinterpret_cast<int8_t*>(out + row * K);
  for (int j = lane; j < K; j += 32) {
    const float r = rintf(__fdiv_rn(xr[j], scale));
    // NaN test before the clip: fminf/fmaxf would turn NaN into a bound
    q[j] = isnan(r) ? int8_t(0)
                    : static_cast<int8_t>(static_cast<int>(
                          fminf(fmaxf(r, -127.0f), 127.0f)));
  }
  if (lane == 0) {
    if (kPack) {
      const unsigned int bits = __float_as_uint(scale);
      uint8_t* s = out + row * (K + 4) + K;
      s[0] = bits & 0xffu;
      s[1] = (bits >> 8) & 0xffu;
      s[2] = (bits >> 16) & 0xffu;
      s[3] = (bits >> 24) & 0xffu;
    } else {
      scales[row] = scale;
    }
  }
}

}  // namespace

// Both entries launch on `stream` and return cudaGetLastError() (0 when
// the launch was accepted).  Pointers are device pointers; x is
// contiguous (T, K) f32.  T == 0 launches nothing.
extern "C" int quantize_pack_int8_launch(const void* x, void* out, int T,
                                         int K, void* stream) {
  if (T > 0) {
    dim3 block(32, kRowsPerBlock);
    dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock);
    quantize_rows<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)x, T, K, (uint8_t*)out, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int quantize_int8_launch(const void* x, void* q, void* scale,
                                    int T, int K, void* stream) {
  if (T > 0) {
    dim3 block(32, kRowsPerBlock);
    dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock);
    quantize_rows<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)x, T, K, (uint8_t*)q, (float*)scale);
  }
  return (int)cudaGetLastError();
}
