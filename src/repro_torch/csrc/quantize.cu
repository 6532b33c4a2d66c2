// Per-row symmetric int8 quantization of the cut payload, for Hopper
// (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface, bound with ctypes
// (repro_torch/kernels/quantize/ops.py).
//
// Replaces the Pallas TPU kernels
//   repro/kernels/quantize/kernel.py::_quantize_pack_kernel  (quantize_pack_int8)
//   repro/kernels/quantize/kernel.py::_quantize_kernel       (quantize_int8)
// and computes exactly what they compute, per row of x (T, K), f32 or
// bf16 (upcast in registers, which is exact):
//   scale = max(absmax_row, 1e-12) / 127
//   q     = clip(round_half_even(x / scale), -127, 127)  as int8
// The packed entry writes the wire frame uint8 (T, K+4): K int8 bytes,
// then the 4 little-endian bytes of the f32 scale.  The unpacked entry
// writes q int8 (T, K) and scale f32 (T, 1).
//
// What bounds it: memory bytes, and at a few rows the latency of one
// DRAM round trip.  It reads 4*T*K bytes (f32) or 2*T*K (bf16) and
// writes T*(K+4) (packed) or T*K + 4*T (unpacked), with about six
// operations per element.  At a llama prefill's (2048, 3072) f32 that
// is 25.2 MB read, 6.3 MB written: 9.4 us at 3.35 TB/s.  At a decode
// tick's (4, 3072) the bytes take 0.02 us and the floor is one load's
// round trip plus a block reduction.  At the training path's (128, 64)
// the launch costs more than the bytes.
//
// The design (the row plan is kernels/quantize/plan.py's, passed in):
//   * a row's threads (tpr: 1-16 lanes of a warp, or whole warps up to
//     1024) each keep up to VPT loads of the row in registers, so x is
//     read once: absmax (shuffles, then shared memory across the warps
//     of a row), scale, and the codes all come from those registers.
//     Few rows get a block each and one load per thread (latency); many
//     rows get a few warps each and 2-4 loads per thread in flight over
//     two waves, so the card holds well over the ~32 KB per SM that
//     Little's law asks at 3.35 TB/s;
//   * 16-byte loads (4 f32 or 8 bf16) where every row starts aligned,
//     4-byte stores of 4 codes, and the scale as one 4-byte store when
//     the frame's row stride K+4 allows it; else one element per load
//     and byte stores;
//   * rows longer than 1024 threads x 8 loads (off every path) walk
//     the row twice in one block, reading x twice, with the same bytes.
// No cluster, TMA or tensor cores: a row's reduction is a few KB with
// no reuse, and registers already hold the bytes in flight that the
// memory needs; a cluster's shared-memory reduction would add a barrier
// to a path whose floor is one DRAM round trip.
//
// Exactness, so that the bytes equal the plain version's and the
// reference's:
//   * true IEEE division x / scale (__fdiv_rn), never a multiply by a
//     reciprocal; the library is built without --use_fast_math;
//   * rintf rounds half to even, as jnp.round and torch.round do;
//   * NaN propagates, as in jnp.max: the row absmax is taken with a max
//     that keeps NaN in any order (fmaxf would drop it), so a row
//     holding NaN gets a NaN scale and the receiver decodes NaN.  A
//     value that quantizes to NaN (NaN input, or inf / inf) is stored
//     as 0 — the plain version does the same, and so does XLA's
//     float-to-int conversion;
//   * a row's bytes depend on nothing but the row: the codes are
//     elementwise and the absmax exact, whatever T or the plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// One load of a row, and its elements as f32.  A bf16's bits are the
// top 16 of the f32 of the same value.
template <bool kBf16, bool kVector>
struct Loader;

template <>
struct Loader<false, true> {            // f32, 16-byte vectors of 4
  static constexpr int N = 4;
  using Raw = uint4;
  __device__ static Raw load(const void* row, int v) {
    return __ldg(static_cast<const uint4*>(row) + v);
  }
  __device__ static float get(const Raw& r, int j) {
    return __uint_as_float(j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w);
  }
};

template <>
struct Loader<true, true> {             // bf16, 16-byte vectors of 8
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const void* row, int v) {
    return __ldg(static_cast<const uint4*>(row) + v);
  }
  __device__ static float get(const Raw& r, int j) {
    const int h = j >> 1;
    const unsigned w = h == 0 ? r.x : h == 1 ? r.y : h == 2 ? r.z : r.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Loader<false, false> {           // f32, one element
  static constexpr int N = 1;
  using Raw = unsigned;
  __device__ static Raw load(const void* row, int v) {
    return __ldg(static_cast<const unsigned*>(row) + v);
  }
  __device__ static float get(const Raw& r, int) { return __uint_as_float(r); }
};

template <>
struct Loader<true, false> {            // bf16, one element
  static constexpr int N = 1;
  using Raw = unsigned;
  __device__ static Raw load(const void* row, int v) {
    return __ldg(static_cast<const unsigned short*>(row) + v);
  }
  __device__ static float get(const Raw& r, int) {
    return __uint_as_float(r << 16);
  }
};

__device__ __forceinline__ uint8_t code(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  // NaN test before the clip: fminf/fmaxf would turn NaN into a bound
  return isnan(r)
             ? uint8_t(0)
             : static_cast<uint8_t>(static_cast<int8_t>(
                   static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f))));
}

// The absmax over a row's tpr threads: shuffles inside a warp (the
// row's lanes, or the whole warp), then, for a row of several warps,
// each warp's partial through shared memory: lane w of every warp of
// the row reads warp w's and the warp shuffles them again, so every
// warp gets the row's max after one barrier.  0 is the identity (every
// partial is >= 0 or NaN).  Every thread of the block calls it.
__device__ __forceinline__ float row_max(float m, int tpr) {
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1)
    m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (tpr > 32) {                       // uniform over the block
    __shared__ float red[kMaxThreads / 32];
    const int tid = threadIdx.y * tpr + threadIdx.x;
    const int wpr = tpr >> 5;           // warps of a row, at most 32
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    const int w = tid & 31;
    m = w < wpr ? red[threadIdx.y * wpr + w] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// Block (tpr, rpb): threadIdx.y is the block's row, threadIdx.x the
// thread of that row.  Thread t holds loads t + i * tpr, i < VPT.
template <bool kBf16, bool kVector, int VPT, bool kPack, bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows(const void* __restrict__ x, int T, int K,
              uint8_t* __restrict__ out, float* __restrict__ scales) {
  using L = Loader<kBf16, kVector>;
  constexpr int N = L::N;
  const int tpr = blockDim.x;
  const int lane = threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < T;            // a ragged last block: masked
  const int nvec = K / N;               // N divides K on the vector path
  const int step = tpr * VPT;           // loads per pass of the block
  const void* xr = static_cast<const char*>(x) +
                   (live ? row : 0) * (long long)K * (kBf16 ? 2 : 4);

  typename L::Raw raw[VPT];
  float m = 0.0f;
  for (int base = 0; base < nvec; base += step) {   // once unless kWide
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = base + lane + i * tpr;
      if (live && v < nvec) raw[i] = L::load(xr, v);
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = base + lane + i * tpr;
      if (live && v < nvec) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          m = max_keep_nan(m, fabsf(L::get(raw[i], j)));
      }
    }
    if (!kWide) break;
  }
  m = row_max(m, tpr);
  const float scale = __fdiv_rn(isnan(m) ? m : fmaxf(m, 1e-12f), 127.0f);
  if (!live) return;                    // no barrier follows

  uint8_t* q = out + row * (long long)(kPack ? K + 4 : K);
  for (int base = 0; base < nvec; base += step) {
    if (kWide) {                        // the second read of a wide row
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int v = base + lane + i * tpr;
        if (v < nvec) raw[i] = L::load(xr, v);
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = base + lane + i * tpr;
      if (v >= nvec) continue;
      if (kVector) {                    // 4 codes per 4-byte store
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const unsigned word =
              unsigned(code(L::get(raw[i], j), scale)) |
              unsigned(code(L::get(raw[i], j + 1), scale)) << 8 |
              unsigned(code(L::get(raw[i], j + 2), scale)) << 16 |
              unsigned(code(L::get(raw[i], j + 3), scale)) << 24;
          *reinterpret_cast<unsigned*>(q + (long long)v * N + j) = word;
        }
      } else {
        q[v] = code(L::get(raw[i], 0), scale);
      }
    }
    if (!kWide) break;
  }
  if (lane == 0) {
    if (kPack) {
      const unsigned bits = __float_as_uint(scale);
      uint8_t* s = q + K;
      if ((K & 3) == 0) {               // the frame's row stride K+4
        *reinterpret_cast<unsigned*>(s) = bits;     // little-endian
      } else {
        s[0] = bits & 0xffu;
        s[1] = (bits >> 8) & 0xffu;
        s[2] = (bits >> 16) & 0xffu;
        s[3] = (bits >> 24) & 0xffu;
      }
    } else {
      scales[row] = scale;
    }
  }
}

__global__ void quantize_noop() {}

template <bool kPack, bool kBf16, bool kVector>
void launch_plan(const void* x, uint8_t* out, float* scales, int T, int K,
                 int vpt, bool wide, dim3 grid, dim3 block, cudaStream_t s) {
  if (wide) {
    quantize_rows<kBf16, kVector, 8, kPack, true>
        <<<grid, block, 0, s>>>(x, T, K, out, scales);
    return;
  }
  switch (vpt) {
    case 1: quantize_rows<kBf16, kVector, 1, kPack, false>
                <<<grid, block, 0, s>>>(x, T, K, out, scales); break;
    case 2: quantize_rows<kBf16, kVector, 2, kPack, false>
                <<<grid, block, 0, s>>>(x, T, K, out, scales); break;
    case 4: quantize_rows<kBf16, kVector, 4, kPack, false>
                <<<grid, block, 0, s>>>(x, T, K, out, scales); break;
    default: quantize_rows<kBf16, kVector, 8, kPack, false>
                <<<grid, block, 0, s>>>(x, T, K, out, scales); break;
  }
}

// The plan's shape rules (plan.py); a plan that breaks one is refused.
bool plan_ok(int T, int K, int bf16, int vector, int tpr, int rpb, int vpt,
             int wide) {
  const int n = vector ? (bf16 ? 8 : 4) : 1;
  const long long threads = (long long)tpr * rpb;
  const bool lanes = (tpr >= 1 && tpr <= 16 && (tpr & (tpr - 1)) == 0) ||
                     (tpr % 32 == 0 && tpr <= kMaxThreads);
  return T > 0 && K > 0 && K % n == 0 && lanes && rpb >= 1 &&
         threads % 32 == 0 && threads <= kMaxThreads &&
         (vpt == 1 || vpt == 2 || vpt == 4 || vpt == 8) &&
         (wide ? vpt == 8 : (long long)tpr * vpt * n >= K);
}

template <bool kPack>
int launch(const void* x, void* out, void* scales, int T, int K, int bf16,
           int vector, int tpr, int rpb, int vpt, int wide, void* stream) {
  if (T == 0) return 0;                 // nothing to launch
  if (!plan_ok(T, K, bf16, vector, tpr, rpb, vpt, wide))
    return (int)cudaErrorInvalidValue;
  const dim3 block(tpr, rpb), grid((T + rpb - 1) / rpb);
  const cudaStream_t s = (cudaStream_t)stream;
  uint8_t* o = (uint8_t*)out;
  float* sc = (float*)scales;
  if (bf16 && vector)
    launch_plan<kPack, true, true>(x, o, sc, T, K, vpt, wide, grid, block, s);
  else if (bf16)
    launch_plan<kPack, true, false>(x, o, sc, T, K, vpt, wide, grid, block, s);
  else if (vector)
    launch_plan<kPack, false, true>(x, o, sc, T, K, vpt, wide, grid, block, s);
  else
    launch_plan<kPack, false, false>(x, o, sc, T, K, vpt, wide, grid, block, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries launch on `stream` and return a cudaError_t (0 when the
// launch was accepted).  Pointers are device pointers; x is contiguous
// (T, K), f32 (bf16 == 0) or bf16 (bf16 == 1), 16-byte aligned when
// vector == 1.  tpr, rpb, vpt, vector, wide: the row plan
// (kernels/quantize/plan.py).  T == 0 launches nothing.
extern "C" int quantize_pack_int8_launch(const void* x, void* out, int T,
                                         int K, int bf16, int vector,
                                         int tpr, int rpb, int vpt,
                                         int wide, void* stream) {
  return launch<true>(x, out, nullptr, T, K, bf16, vector, tpr, rpb, vpt,
                      wide, stream);
}

extern "C" int quantize_int8_launch(const void* x, void* q, void* scale,
                                    int T, int K, int bf16, int vector,
                                    int tpr, int rpb, int vpt, int wide,
                                    void* stream) {
  return launch<false>(x, q, scale, T, K, bf16, vector, tpr, rpb, vpt, wide,
                       stream);
}

// An empty kernel on the grid and block of a plan: the launch floor
// that the quantize times are read against.
extern "C" int quantize_noop_launch(int blocks, int tpr, int rpb,
                                    void* stream) {
  quantize_noop<<<blocks, dim3(tpr, rpb), 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
