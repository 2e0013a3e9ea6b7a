// The speech encoder's feature-encoder norm: the convolution's bias, the LayerNorm over the
// channels, the exact GELU and the cast to the compute dtype in one pass, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no TPU kernel: the speech encoder (models/speech_encoder.py) exists in the port
// alone. Its plain path runs each of the feature encoder's seven layers as cuDNN's convolution
// with its bias, then F.layer_norm, then F.gelu: the bias add, the norm and the activation each
// read and write the whole (B, T, C) activation, three passes where one does.
//
// What it computes, for each row of a dense (rows, C) activation x in bf16 or fp32 (a
// channels-last convolution's output without its bias, (B, T, C)) and the layer's bias,
// LayerNorm weight and LayerNorm bias in x's dtype:
//   v = x + bias;  mean, var = the mean and biased variance of v over the row's C channels
//   y = cast(gelu((v - mean) * rsqrtf(var + eps) * weight + beta)),
//   gelu(t) = t * 0.5 * (1 + erff(t / sqrt(2)))   (F.gelu's exact form)
// all in fp32, rounded once, at the output. The plain path rounds v and the LayerNorm's output
// to the compute dtype before the next pass; this kernel keeps both in fp32. The statistics are
// two sums over values held in registers (the mean, then the squares about it: no
// cancellation), in another order than the plain path's Welford reduction, so an output lies
// within one bf16 ulp of the plain function taken in fp32 (ops/ln_gelu.py::ln_gelu_plain) plus
// that fp32 round-off.
//
// What bounds it on an H100: bytes. HuBERT Large's seven layers at B = 128 and 68,267 samples
// hold 1,775,042,560 elements (T = 13,652 down to 213, C = 512), read once and written once in
// bf16: 7.1 GB, 2.12 ms at 3.35 TB/s. Its some 40 instructions an element (erff's about half of
// them) come near the SMs' instruction rate over that time, so the arithmetic has to hide under
// the loads: without the GELU the same pass runs at a copy's speed.
//
// Design:
//  - One warp a row. A lane loads VEC adjacent channels (16 bytes: 8 bf16 or 4 fp32) of each
//    chunk of 32 x VEC channels, so a warp reads a chunk as 512 contiguous bytes; at C = 512 in
//    bf16 a lane holds 16 values from two loads.
//  - A lane owns the same channels in every row it takes, so it holds their bias, weight and
//    beta in registers (48 floats at C = 512 bf16), loaded once.
//  - The mean and the variance are warp-shuffle butterflies over the registers: the row is read
//    from memory once and written once.
//  - A persistent grid (the blocks resident at once, at most) strides over the rows, a warp a
//    row at a time; the next row's loads are started before this row is computed, so a row's
//    bytes are in flight through the arithmetic of the one before. At C = 512 in bf16 that
//    leaves two blocks (16 warps) an SM; every chunk of a row full (FULL) drops the per-lane
//    bounds test. Two rows loaded at once, more blocks under fewer registers, and bias, weight
//    and beta in shared memory were measured beside it (PERF.md).
//  - Loads and stores are streaming (evict-first, __ldcs / __stcs): every byte is touched once.
// C is a multiple of 8 up to MAX_C (a chunk that C does not fill leaves its last lanes idle:
// HuBERT's 512 fills two bf16 chunks exactly); rows start 16-byte aligned (C a multiple of 8
// and an aligned base). No shared memory, no synchronisation, no allocation: the launch is safe
// to capture in a CUDA graph.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VALUES = 32;      // values a lane holds of a row
constexpr int MAX_C = 32 * MAX_VALUES;
constexpr float SQRT1_2 = 0.70710678118654752440f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane adds the same two operands at each step, so all hold one sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float t) {  // as ATen's GeluCUDAKernelImpl writes it
  return t * 0.5f * (1.0f + erff(t * SQRT1_2));
}

struct Params {
  uint32_t rows, C;
  float inv_c, eps;
};

template <typename T, int CHUNKS, bool FULL>
__global__ void __launch_bounds__(THREADS, CHUNKS <= 2 ? 2 : 1)
ln_gelu_kernel(const T* __restrict__ x, T* __restrict__ y, const T* __restrict__ bias,
               const T* __restrict__ weight, const T* __restrict__ beta, const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const uint32_t vrow = FULL ? CHUNKS * 32 : p.C / VEC;  // 16-byte vectors a row
  // lane's vector in chunk k: (k x 32 + lane); on(k) where the row has it
  auto on = [&](int k) { return FULL || (uint32_t)(k * 32 + lane) < vrow; };

  float b[CHUNKS][VEC], g[CHUNKS][VEC], be[CHUNKS][VEC];
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const uint32_t c0 = (k * 32 + lane) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const bool in = on(k);
      b[k][i] = in ? to_f32(bias[c0 + i]) : 0.f;
      g[k][i] = in ? to_f32(weight[c0 + i]) : 0.f;
      be[k][i] = in ? to_f32(beta[c0 + i]) : 0.f;
    }
  }

  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const uint32_t first = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const uint32_t step = gridDim.x * WARPS;
  uint4 next[CHUNKS];
  auto load = [&](uint32_t row) {
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
      next[k] = on(k) ? __ldcs(xv + (size_t)row * vrow + k * 32 + lane) : make_uint4(0, 0, 0, 0);
  };
  if (first < p.rows) load(first);
  for (uint32_t row = first; row < p.rows; row += step) {
    uint4 raw[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) raw[k] = next[k];
    if (row + step < p.rows) load(row + step);
    float v[CHUNKS][VEC];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const T* a = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[k][i] = on(k) ? to_f32(a[i]) + b[k][i] : 0.f;
        s += v[k][i];
      }
    }
    const float mean = warp_sum(s) * p.inv_c;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[k][i] = on(k) ? v[k][i] - mean : 0.f;
        q += v[k][i] * v[k][i];
      }
    const float rstd = rsqrtf(warp_sum(q) * p.inv_c + p.eps);
    uint4* out = yv + (size_t)row * vrow;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      if (!on(k)) continue;
      uint4 o;
      T* t = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        t[i] = from_f32<T>(gelu(v[k][i] * rstd * g[k][i] + be[k][i]));
      __stcs(out + k * 32 + lane, o);
    }
  }
}

template <typename T, int CHUNKS, bool FULL>
cudaError_t launch(const T* x, T* y, const T* bias, const T* weight, const T* beta,
                   const Params& p, cudaStream_t stream) {
  static int resident = 0;  // blocks resident on the card at once; one query an instantiation
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_gelu_kernel<T, CHUNKS, FULL>, THREADS, 0);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const uint32_t need = (p.rows + WARPS - 1) / WARPS;
  const uint32_t blocks = need < (uint32_t)resident ? need : (uint32_t)resident;
  ln_gelu_kernel<T, CHUNKS, FULL><<<blocks, THREADS, 0, stream>>>(x, y, bias, weight, beta, p);
  return cudaGetLastError();
}

// the instantiation whose CHUNKS is the row's chunk count, from the largest down
template <typename T, int CHUNKS>
cudaError_t dispatch(int chunks, const T* x, T* y, const T* bias, const T* weight,
                     const T* beta, const Params& p, cudaStream_t stream) {
  if constexpr (CHUNKS > 1)
    if (chunks < CHUNKS) return dispatch<T, CHUNKS - 1>(chunks, x, y, bias, weight, beta, p,
                                                        stream);
  constexpr int VEC = 16 / sizeof(T);
  if (p.C == CHUNKS * 32 * VEC)
    return launch<T, CHUNKS, true>(x, y, bias, weight, beta, p, stream);
  return launch<T, CHUNKS, false>(x, y, bias, weight, beta, p, stream);
}

template <typename T>
cudaError_t run(const void* x, void* y, const void* bias, const void* weight, const void* beta,
                const Params& p, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (int)((p.C / VEC + 31) / 32);
  return dispatch<T, MAX_VALUES / VEC>(chunks, static_cast<const T*>(x), static_cast<T*>(y),
                                       static_cast<const T*>(bias),
                                       static_cast<const T*>(weight),
                                       static_cast<const T*>(beta), p, stream);
}

}  // namespace

// x, y: dense (rows, C) rows, bf16 (is_bf16) or fp32, 16-byte aligned; bias, weight, beta: C
// each in x's dtype. C a multiple of 8 from 8 to 1,024, rows under 2^31. Returns the launch
// error, cudaErrorInvalidValue for a shape or an alignment it does not take.
extern "C" int sdt_ln_gelu_forward(const void* x, void* y, const void* bias, const void* weight,
                                   const void* beta, int is_bf16, int rows, int C, float eps,
                                   void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (rows < 0 || C < 8 || C > MAX_C || C % 8 != 0 || ptrs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Params p{(uint32_t)rows, (uint32_t)C, 1.0f / (float)C, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run<bf16>(x, y, bias, weight, beta, p, st)
                       : run<float>(x, y, bias, weight, beta, p, st));
}
