// Flash attention forward for Hopper (sm_90a), f32 or bf16 inputs.
// Built by repro_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, bound with ctypes
// (repro_torch/kernels/block_attention/ops.py).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/block_attention/kernel.py::_attn_kernel
//   (flash_attention_flat, wrapped by block_attention/ops.py)
// and computes what it computes, for q (B, Sq, nh, hd) and k, v
// (B, Skv, nkv, hd) read in place through their strides (no transposed
// copy):
//   * q scaled by `scale` (hd^-0.5) in f32 before the product;
//   * GQA: q head h reads kv head h / (nh / nkv);
//   * masks causal (k <= q), local (k <= q and k > q - window), bidir;
//   * tanh soft-capping cap * tanh(s / cap) when cap > 0;
//   * masked scores set to NEG_INF = -2^30, never -inf;
//   * online softmax with m, l and acc in f32, output acc / max(l, 1e-30)
//     cast to the input type;
//   * kv tiles that the mask leaves empty for the whole q tile skipped.
// Beyond the TPU kernel it takes the two arguments the serving path
// needs: q_offset (query row i sits at position q_offset + i) and
// kv_lim = min(kv_len, Skv) (keys at positions >= kv_lim are masked).
// q_offset = 0 and kv_lim = Skv give the TPU kernel's function.  When
// some row of the call sees no key (`full`, decided by the wrapper:
// block_attention/plan.py::has_empty_row), every q tile walks the whole
// cache [0, Skv) and skips no tile, so such a row gets the reference's
// uniform weights over all Skv keys (the mean of V); keys past the
// walked range, the zero-filled tail of the last tile, weigh 0.
//
// Design: one block of 16 x 16 threads per (q tile of 64 rows, batch x
// q head).  The q tile is staged in shared memory once, scaled, in f32.
// A loop walks the live kv tiles of 64 keys: the K tile is staged in
// shared memory (f32, rows padded by one float so that no two lanes of a
// warp hit one bank), each thread computes a 4 x 4 block of scores
// (rows ty*4..ty*4+3, keys tx, tx+16, tx+32, tx+48), the row max and
// sum are reduced across the 16 lanes of a row group with shuffles, the
// probabilities go to shared memory, the V tile replaces the K tile,
// and each thread accumulates its 4 rows x (HD / 16) head-dim columns
// of P.V in registers.  Scores, softmax and P.V run in f32 on the CUDA
// cores, as the reference computes them.
//
// What bounds it: operations.  The work is 4 * hd flops per live
// (query, key) pair against (|q| + |k| + |v| + |o|) bytes; at the
// serving path's prefill shapes that is far above the card's
// flops-per-byte ridge.  This first design does not use the tensor
// cores (no wgmma, no TMA): every product is an f32 FMA, and a thread
// issues one shared-memory load per two FMAs.  It is the `fma` route of
// block_attention/ops.py: f32 prefills and bf16 calls the tensor-core
// route does not take; decode calls take csrc/attention_decode.cu.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per kv tile
constexpr int kTX = 16;            // threads along keys / head dim
constexpr int kTY = 16;            // threads along query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;   // query rows per thread
constexpr int kCols = kBK / kTX;   // keys per thread
constexpr int kLdP = kBK + 1;      // padded row stride of the P tile
constexpr float kNegInf = -1073741824.0f;  // -2^30, the reference's

enum Kind { kCausal = 0, kLocal = 1, kBidir = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, nh, nkv, hd;
  long long qs_b, qs_s, qs_h;      // element strides of q, k, v
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  int kind, window, kv_lim, q_offset;
  int full;                        // walk [0, Skv): some row sees no key
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [r0, r0 + 64) of a (S, hd) slice as f32, times `mul`, into
// a (64, HD + 1) shared tile; rows at or past `r_end` and columns at or
// past hd are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long row_stride, int r0,
                                      int r_end, int hd, float mul) {
  constexpr int LD = HD + 1;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  for (int i = tid; i < kBK * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.0f;
    if (r0 + r < r_end && d < hd)
      x = to_f32(src[(long long)(r0 + r) * row_stride + d]) * mul;
    dst[r * LD + d] = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_fwd(Params p) {
  constexpr int LD = HD + 1;       // padded row stride of the q / kv tiles
  constexpr int NJ = HD / kTX;     // head-dim columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // kBQ x LD
  float* sKV = sQ + kBQ * LD;      // kBK x LD: the K tile, then the V tile
  float* sP = sKV + kBK * LD;      // kBQ x kLdP

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / p.nh, h = blockIdx.y % p.nh;
  const int kvh = h / (p.nh / p.nkv);
  const T* Q = static_cast<const T*>(p.q) + b * p.qs_b + h * p.qs_h;
  const T* K = static_cast<const T*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const T* V = static_cast<const T*>(p.v) + b * p.vs_b + kvh * p.vs_h;

  stage<T, HD>(sQ, Q, p.qs_s, q0, p.Sq, p.hd, p.scale);

  // the live kv range of this q tile: [k_begin, k_end)
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

  float m_i[kRows], l_i[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();               // the last tile's P.V has read sKV, sP
    stage<T, HD>(sKV, K, p.ks_s, k0, k_end, p.hd, 1.0f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sKV[(tx + j * kTX) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = p.q_offset + q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + j * kTX;
        float x = s[i][j];
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kp < p.kv_lim;
        if (p.kind == kCausal) ok = ok && kp <= qp;
        else if (p.kind == kLocal) ok = ok && kp <= qp && kp > qp - p.window;
        s[i][j] = kp >= k_end ? -INFINITY : ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row group share one ty: xor offsets < 16 stay
      // inside the group
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sP[(ty * kRows + i) * kLdP + tx + j * kTX] = s[i][j];
    }

    __syncthreads();               // every thread is done with the K tile
    stage<T, HD>(sKV, V, p.vs_s, k0, k_end, p.hd, 1.0f);
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = sP[(ty * kRows + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sKV[c * LD + tx + j * kTX];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  // the output is contiguous (B, Sq, nh, hd)
  T* O = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qr = q0 + ty * kRows + i;
    if (qr >= p.Sq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = O + (((long long)b * p.Sq + qr) * p.nh + h) * p.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + j * kTX;
      if (d < p.hd) store(orow + d, acc[i][j] / l);
    }
  }
}

template <typename T, int HD>
int launch(const Params& p, int B, void* stream) {
  constexpr int LD = HD + 1;
  const int smem = (int)sizeof(float) * (kBQ * LD + kBK * LD + kBQ * kLdP);
  // above 48 KB a block's dynamic shared memory has to be allowed first
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, B * p.nh);
  dim3 block(kTX, kTY);
  attn_fwd<T, HD><<<grid, block, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Params& p, int B, void* stream) {
  if (p.hd <= 32) return launch<T, 32>(p, B, stream);
  if (p.hd <= 64) return launch<T, 64>(p, B, stream);
  if (p.hd <= 128) return launch<T, 128>(p, B, stream);
  return launch<T, 256>(p, B, stream);
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 when the
// launch was accepted).  dtype 0 = f32, 1 = bf16 (q, k, v and o share
// it).  Strides are in elements; the last dimension of q, k and v is
// contiguous.  kind 0 = causal, 1 = local, 2 = bidir; full = 1 walks
// every key of [0, Skv) (some row sees no key).  The wrapper
// checks 1 <= hd <= 256, nh % nkv == 0 and B * nh <= 65535.
extern "C" int block_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int nh, int nkv, int hd, long long qs_b, long long qs_s,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, int kind, int window,
    int kv_lim, int q_offset, int full, float softcap, float scale,
    void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaGetLastError();
  Params p{q, k, v, o, Sq, Skv, nh, nkv, hd,
           qs_b, qs_s, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h,
           kind, window, kv_lim, q_offset, full, softcap, scale};
  if (dtype == 0) return launch_hd<float>(p, B, stream);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}
