// Eval-mode BatchNorm + leaky ReLU + the cast to the compute dtype in one pass, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package leaves eval BN, lrelu and the cast to XLA, which
// fuses them. The port's plain path (models/blocks.py: BatchNorm.forward in eval mode,
// F.leaky_relu, .to(dtype)) runs them as separate fp32 elementwise passes: a cast up, four
// broadcast passes, the lrelu and a cast down, each reading and writing the whole activation.
//
// What it computes, for a (B, C, H, W) or (B, C, T) activation in bf16 or fp32
// and the layer's four fp32 vectors:
//   y = cast(lrelu(((x - mean_c) * rstd_c) * w_c + b_c)),   rstd_c = rsqrtf(var_c + 1e-5)
// each step one fp32 operation rounded where the plain path rounds it (subtract, multiply,
// multiply, add, then x > 0 ? x : x * slope), none contracted into an FMA, and one rounding to
// the output dtype: the output is the plain path's bit for bit. (A fold into scale = w * rstd
// and shift = b - mean * scale would save two operations an element, which a pass bound by
// bytes does not need, and would round otherwise: by many fp32 ulps where x lies near mean_c.)
//
// What bounds it on an H100: bytes. s2g's 24 BN layers at B = 128 and 427 mel frames hold
// 655,196,160 elements, read once and written once in bf16: 2.62 GB, 0.78 ms at 3.35 TB/s;
// five flops an element are nothing beside that.
//
// Design: one launch a layer over the flattened tensor, of under 2^31 elements (s2g's
// largest, layer 0 at B = 128, holds 2.8e8), so that indices are 32-bit. A thread owns UNROLL vectors of VEC
// adjacent elements (16 bytes: 8 bf16 or 4 fp32), THREADS vectors apart, all loaded before any
// is computed; a warp reads 512 contiguous bytes a load. The caller hands the activation as a
// dense (N, C, S) slab, the channel of element e being (e / S) mod C: an NCHW or (B, C, T)
// tensor as itself (S = H x W, or T), a channels-last (B, C, H, W) one as (B x H x W, C, 1),
// which cuDNN reads and writes without a transpose. Two routes, one template:
//  - PLANES: a vector finds its first element's row by a multiply-high division by S (and the
//    channel by one by C) and steps to the next channel where a row ends inside it, so every S
//    works (10 x 53 = 530, 5 x 51 = 255, T = 2, and S = 1 at any C) without padding; rstd is
//    computed where a channel is first used, from L1-cached loads.
//  - CHANNELS_INNER: S = 1 and C divides a thread's step THREADS x VEC (C = 64, 128, 256: the
//    2-D encoder channels-last): element e's channel is e mod C, the same for a thread's VEC
//    lanes at every unrolled step, so the thread loads its VEC channels' (mean, rstd, w, b)
//    into registers once and no element steps channels.
// A pointer that is not 16-byte aligned takes VEC = 1; the last partial vector is done element
// by element. No shared memory, no synchronisation, no allocation: the launch is safe to
// capture in a CUDA graph.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr float EPS = 1e-5f;      // models/blocks.py NORM_EPS
constexpr int64_t MAX_N = 0x7fffffff;

typedef __nv_bfloat16 bf16;

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (d >= 1)
struct FastDiv {
  uint32_t d, m, s;
  explicit FastDiv(uint32_t d_) : d(d_) {
    for (s = 0; s < 32; ++s)
      if ((1u << s) >= d) break;
    m = (uint32_t)(((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const { return (__umulhi(n, m) + n) >> s; }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Channel {
  float mean, rstd, w, b;
};

struct Params {
  const float* __restrict__ mean;
  const float* __restrict__ var;
  const float* __restrict__ w;
  const float* __restrict__ b;
  float slope;
  uint32_t n, S, C;
  FastDiv div_s, div_c;

  __device__ __forceinline__ Channel channel(uint32_t c) const {
    return {__ldg(mean + c), rsqrtf(__fadd_rn(__ldg(var + c), EPS)), __ldg(w + c), __ldg(b + c)};
  }
  __device__ __forceinline__ float apply(float x, const Channel& p) const {
    float t = __fmul_rn(__fsub_rn(x, p.mean), p.rstd);
    t = __fadd_rn(__fmul_rn(t, p.w), p.b);
    return t > 0.f ? t : __fmul_rn(t, slope);
  }
};

enum Route { PLANES, CHANNELS_INNER };

// what a thread loads and stores at once: 16 bytes, or one element
template <typename T, int VEC> struct VecOf { typedef uint4 type; };
template <typename T> struct VecOf<T, 1> { typedef T type; };

template <typename T, int VEC, Route ROUTE>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p) {
  typedef typename VecOf<T, VEC>::type V;
  static_assert(sizeof(V) == VEC * sizeof(T), "a vector is VEC elements");
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  const uint32_t full = p.n / VEC;
  const uint32_t first = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  V in[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const uint32_t k = first + u * THREADS;
    if (k < full) in[u] = xv[k];
  }
  if constexpr (ROUTE == CHANNELS_INNER) {
    // every vector of this thread starts at channel (threadIdx.x x VEC) mod C
    Channel ch[VEC];
    const uint32_t c0 = (threadIdx.x * VEC) % p.C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) ch[i] = p.channel((c0 + i) % p.C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t k = first + u * THREADS;
      if (k >= full) break;
      const T* a = reinterpret_cast<const T*>(&in[u]);
      V out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = from_f32<T>(p.apply(to_f32(a[i]), ch[i]));
      yv[k] = out;
    }
  } else {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t k = first + u * THREADS;
      if (k >= full) break;
      const uint32_t e = k * VEC;
      const uint32_t row = p.div_s.div(e);
      uint32_t c = row - p.div_c.div(row) * p.C;
      uint32_t next = (row + 1) * p.S;  // the first element of the next row
      Channel ch = p.channel(c);
      const T* a = reinterpret_cast<const T*>(&in[u]);
      V out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (e + i == next) {
          c = c + 1 == p.C ? 0 : c + 1;
          next += p.S;
          ch = p.channel(c);
        }
        o[i] = from_f32<T>(p.apply(to_f32(a[i]), ch));
      }
      yv[k] = out;
    }
  }
  // the last n mod VEC elements, one a thread of the first block
  const uint32_t e = full * VEC + threadIdx.x;
  if (blockIdx.x == 0 && e < p.n) {
    const uint32_t row = p.div_s.div(e);
    y[e] = from_f32<T>(p.apply(to_f32(x[e]), p.channel(row - p.div_c.div(row) * p.C)));
  }
}

template <typename T, int VEC>
void launch_route(const T* x, T* y, const Params& p, cudaStream_t stream) {
  const uint32_t per_block = THREADS * UNROLL;
  const uint32_t blocks = (p.n / VEC + per_block - 1) / per_block;
  const dim3 grid(blocks > 0 ? blocks : 1);
  if (p.S == 1 && (THREADS * VEC) % p.C == 0)
    bn_act_kernel<T, VEC, CHANNELS_INNER><<<grid, THREADS, 0, stream>>>(x, y, p);
  else
    bn_act_kernel<T, VEC, PLANES><<<grid, THREADS, 0, stream>>>(x, y, p);
}

template <typename T>
cudaError_t launch(const T* x, T* y, const Params& p, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (aligned)
    launch_route<T, 16 / sizeof(T)>(x, y, p, stream);
  else
    launch_route<T, 1>(x, y, p, stream);
  return cudaGetLastError();
}

}  // namespace

// x, y: a dense (B, C, S) slab, bf16 (is_bf16) or fp32, under 2^31 elements, the channel of
// element e being (e / S) mod C (a channels-last (B, C, H, W) as (B x H x W, C, 1)); mean, var,
// w, b: C fp32 each. Returns the launch error, cudaErrorInvalidValue for a shape it does not take.
extern "C" int sdt_bn_act_forward(const void* x, void* y, const float* mean, const float* var,
                                  const float* w, const float* b, int is_bf16, int B, int C,
                                  int S, float slope, void* stream) {
  const int64_t n = (int64_t)B * C * S;
  if (B < 0 || C < 1 || S < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const Params p{mean, var, w, b, slope, (uint32_t)n, (uint32_t)S, (uint32_t)C,
                 FastDiv((uint32_t)S), FastDiv((uint32_t)C)};
  const cudaError_t err =
      is_bf16 ? launch(static_cast<const bf16*>(x), static_cast<bf16*>(y), p,
                       static_cast<cudaStream_t>(stream))
              : launch(static_cast<const float*>(x), static_cast<float*>(y), p,
                       static_cast<cudaStream_t>(stream));
  return (int)err;
}
