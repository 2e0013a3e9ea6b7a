// Fused audio-encoder stem for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel probes/stem_pallas.py (_stem_pallas, body
// _make_kernel): on conv1's output, IN1 + lrelu, conv2 64->64 k4 s2 p1,
// IN2 + lrelu, conv3 64->128 k3 s1 p1, IN3 + lrelu. InstanceNorm statistics are
// fp32, variance E[x^2] - E[x]^2 (biased), eps 1e-5, as in the Pallas kernel.
// conv1 (1 -> 64, K = 9) stays outside, in PyTorch, as it stayed in XLA.
//
// What bounds it on an H100: at B=128, W1=427 the two convolutions are
// 2 * 1.09M pixels * (64*1024 + 128*576) = 304 GFLOP, ~0.31 ms at the bf16
// dense tensor-core peak; one pass over its input and output moves 0.84 GB,
// ~0.25 ms at 3.35 TB/s. So it is near the ridge, and every extra pass over a
// full-resolution plane costs as much as the arithmetic.
//
// Design. The TPU kernel held a whole sample's plane in VMEM; one 80x427x64
// plane is 4.4 MB in bf16 and a Hopper block has 227 KB, so here blocks tile the
// planes and each InstanceNorm needs a cross-block reduction:
//   1. row_stats: per-(sample, row, channel) sum and sum of squares of conv1's
//      output, then finalize: partials summed in a fixed order (no atomics, so
//      the result is deterministic) into mean and 1/sqrt(var + eps).
//   2. conv_in (conv2, then conv3): implicit GEMM, one block of 8 warps per 128
//      output pixels of one row x all output channels. For each kernel row the
//      block stages, once, the input row segment its pixels read and that row's
//      weights (16-byte loads); every tap of the row is then a product of a
//      shifted view of that segment, so the input is read KH times, not KH*KW.
//      As it stages the input it applies the previous layer's normalization and
//      lrelu and casts to the compute dtype; taps that fall outside the plane
//      read 0 AFTER the normalization (PyTorch pads the activated tensor). bf16
//      runs on the tensor cores (mma.sync m16n8k16, fp32 accumulation); fp32 runs
//      on the CUDA cores with the same fragment layout. The raw fp32 output is
//      written once and the epilogue writes per-block channel sums for the next
//      norm, reduced over the warps in a fixed order.
//   3. apply: IN3 + lrelu + cast to the compute dtype, four channels a thread.
// So conv1's output is read twice (stats, conv2), conv2's and conv3's raw fp32
// outputs once each after being written. No double buffering, TMA or wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H1 = 80;         // conv1 output height (mel bins)
constexpr int C1 = 64;         // conv1 / conv2 channels (= conv input channels)
constexpr int C3 = 128;        // conv3 channels
constexpr int TM = 128;        // output pixels per conv block: 8 warps x 16 rows
constexpr int CONV_THREADS = 256;
constexpr float EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : slope * v; }

// Per-(sample, row h, channel) partial sums of an NHWC plane (C1 channels).
// grid (H, B), 256 threads = 4 lanes x 64 channels.
template <typename T>
__global__ void __launch_bounds__(256)
row_stats_kernel(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
                 int H, int W) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int c = threadIdx.x & (C1 - 1), lane = threadIdx.x >> 6;
  const T* row = x + ((size_t)b * H + h) * W * C1;
  float s = 0.f, q = 0.f;
  for (int w = lane; w < W; w += 4) {
    const float v = to_f(row[(size_t)w * C1 + c]);
    s += v;
    q = fmaf(v, v, q);
  }
  __shared__ float rs[4][C1], rq[4][C1];
  rs[lane][c] = s;
  rq[lane][c] = q;
  __syncthreads();
  if (lane == 0) {
    const size_t o = ((size_t)b * H + h) * C1 + c;
    psum[o] = ((rs[0][c] + rs[1][c]) + rs[2][c]) + rs[3][c];
    psq[o] = ((rq[0][c] + rq[1][c]) + rq[2][c]) + rq[3][c];
  }
}

// Sum P partials per (sample, channel) in order; write mean and 1/sqrt(var + eps).
__global__ void finalize_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                                float* __restrict__ mean, float* __restrict__ rstd,
                                int B, int P, int C, float n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.f, q = 0.f;
  for (int p = 0; p < P; ++p) {
    const size_t o = ((size_t)b * P + p) * C + c;
    s += psum[o];
    q += psq[o];
  }
  const float m = s / n;
  mean[i] = m;
  rstd[i] = rsqrtf(q / n - m * m + EPS);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared-memory row strides (elements). bf16: the 8 rows one fragment load
// touches (stride S apart) land in distinct banks; fp32: odd word stride.
template <typename TC, int S> struct Stride {
  static constexpr int A = sizeof(TC) == 2 ? (S == 1 ? 72 : 68) : C1 + 1;
  static constexpr int B = sizeof(TC) == 2 ? 72 : C1 + 1;
};

// 8 consecutive channels of one pixel, as floats
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* src, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = v[i];
}
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<__nv_bfloat162*>(dst + 2 * i) = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
}

// acc[j][0..3] += A x B over all C1 input channels for one tap. A rows are the
// staged input pixels (row p*S for output pixel p, already shifted by the tap's
// dx); B is the tap's (COUT, C1) weight block. The accumulator layout is
// mma.sync's m16n8 C fragment: rows g and g+8 of this warp's 16 pixels, columns
// 2*tig and 2*tig+1 of each n8 tile (g = lane / 4, tig = lane % 4).
template <typename TC, int S, int NT, int ASTR, int BSTR>
__device__ __forceinline__ void tap_product(const TC* __restrict__ A, const TC* __restrict__ Bt,
                                            float (*acc)[4], int warp, int g, int tig) {
  const TC* a0p = A + (warp * 16 + g) * S * ASTR;
  const TC* a1p = a0p + 8 * S * ASTR;
  if constexpr (sizeof(TC) == 2) {
#pragma unroll
    for (int ks = 0; ks < C1; ks += 16) {
      const int k = ks + tig * 2;
      const uint32_t a[4] = {lds32(a0p + k), lds32(a1p + k), lds32(a0p + k + 8),
                             lds32(a1p + k + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const TC* bp = Bt + (j * 8 + g) * BSTR + k;
        mma_bf16_16816(acc[j], a, lds32(bp), lds32(bp + 8));
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < C1; ++k) {
      const float x0 = a0p[k], x1 = a1p[k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = Bt[(j * 8 + tig * 2) * BSTR + k];
        const float b1 = Bt[(j * 8 + tig * 2 + 1) * BSTR + k];
        acc[j][0] = fmaf(x0, b0, acc[j][0]);
        acc[j][1] = fmaf(x0, b1, acc[j][1]);
        acc[j][2] = fmaf(x1, b0, acc[j][2]);
        acc[j][3] = fmaf(x1, b1, acc[j][3]);
      }
    }
  }
}

template <typename TC, int KW, int S, int COUT>
constexpr int conv_smem_bytes() {
  return (((TM - 1) * S + KW) * Stride<TC, S>::A + KW * COUT * Stride<TC, S>::B) * (int)sizeof(TC);
}

// y = conv(lrelu(norm(x))) for TM output pixels of row ho of sample b, all COUT
// channels. For each kernel row dy the block stages, once, the input row segment
// those pixels read ((TM-1)*S + KW pixels x 64 channels, normalized, activated
// and cast) and the KW taps' weights; then every tap of that row is a product of
// shifted views of the staged segment with the staged weights.
// x: (B, Hin, Win, C1) raw previous-layer output; wt: (KH, KW, COUT, C1) in TC;
// y: (B, Hout, Wout, COUT) fp32 raw; psum/psq: (B, Hout * gridDim.x, COUT).
template <typename TIn, typename TC, int KH, int KW, int S, int P, int COUT>
__global__ void __launch_bounds__(CONV_THREADS, 2)
conv_in_kernel(const TIn* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rstd, const TC* __restrict__ wt,
               float* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
               int Hin, int Win, int Hout, int Wout, float slope) {
  constexpr int NT = COUT / 8;
  constexpr int WARPS = CONV_THREADS / 32;
  constexpr int AROWS = (TM - 1) * S + KW;
  constexpr int ASTR = Stride<TC, S>::A, BSTR = Stride<TC, S>::B;
  constexpr int VEC = 16 / (int)sizeof(TC);  // weight elements per 16-byte load
  static_assert(TM == WARPS * 16, "one 16-row fragment per warp");
  static_assert(sizeof(TC) == 4 || (AROWS * ASTR * sizeof(TC)) % 16 == 0,
                "bf16 weight tile takes 16-byte stores");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TC* As = reinterpret_cast<TC*>(smem_raw);  // [AROWS][ASTR]
  TC* Bs = As + AROWS * ASTR;                // [KW][COUT][BSTR]
  __shared__ float s_mean[C1], s_rstd[C1];
  __shared__ float red_s[WARPS][COUT], red_q[WARPS][COUT];

  const int w0 = blockIdx.x * TM, ho = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  if (tid < C1) {
    s_mean[tid] = mean[b * C1 + tid];
    s_rstd[tid] = rstd[b * C1 + tid];
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int wbase = w0 * S - P;  // input column of staged row 0
  for (int dy = 0; dy < KH; ++dy) {
    const int hi = ho * S - P + dy;
    __syncthreads();  // the previous row's tiles are consumed; s_mean/s_rstd visible
    if (hi < 0 || hi >= Hin) continue;  // a row of padding contributes nothing
    const TIn* xrow = x + ((size_t)b * Hin + hi) * Win * C1;
    for (int i = tid; i < AROWS * (C1 / 8); i += CONV_THREADS) {
      const int r = i / (C1 / 8), c = (i % (C1 / 8)) * 8;
      const int wi = wbase + r;
      float v[8];
      if (wi >= 0 && wi < Win) {
        load8(xrow + (size_t)wi * C1 + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = lrelu((v[e] - s_mean[c + e]) * s_rstd[c + e], slope);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;  // padding reads 0 after the norm
      }
      store8(As + r * ASTR + c, v);
    }
    const TC* wsrc = wt + (size_t)dy * KW * COUT * C1;
    for (int i = tid; i < KW * COUT * (C1 / VEC); i += CONV_THREADS) {
      const int row = i / (C1 / VEC), c = (i % (C1 / VEC)) * VEC;  // row = dx * COUT + n
      const uint4 u = *reinterpret_cast<const uint4*>(wsrc + (size_t)row * C1 + c);
      if constexpr (sizeof(TC) == 2) {
        *reinterpret_cast<uint4*>(Bs + row * BSTR + c) = u;
      } else {
        const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) Bs[row * BSTR + c + e] = f[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int dx = 0; dx < KW; ++dx)
      tap_product<TC, S, NT, ASTR, BSTR>(As + dx * ASTR, Bs + dx * COUT * BSTR, acc, warp, g,
                                         tig);
  }

  // epilogue: raw fp32 output + per-block channel sums over the valid pixels
  const int r0 = w0 + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < Wout, v1 = r1 < Wout;
  float* yrow = y + ((size_t)b * Hout + ho) * Wout * COUT;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + tig * 2;
    if (v0) *reinterpret_cast<float2*>(&yrow[(size_t)r0 * COUT + col]) = make_float2(acc[j][0], acc[j][1]);
    if (v1) *reinterpret_cast<float2*>(&yrow[(size_t)r1 * COUT + col]) = make_float2(acc[j][2], acc[j][3]);
    const float e0 = v0 ? acc[j][0] : 0.f, e1 = v0 ? acc[j][1] : 0.f;
    const float e2 = v1 ? acc[j][2] : 0.f, e3 = v1 ? acc[j][3] : 0.f;
    float s0 = e0 + e2, s1 = e1 + e3;
    float q0 = e0 * e0 + e2 * e2, q1 = e1 * e1 + e3 * e3;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over g: lanes with the same tig
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      q0 += __shfl_xor_sync(0xffffffffu, q0, off);
      q1 += __shfl_xor_sync(0xffffffffu, q1, off);
    }
    if (g == 0) {
      red_s[warp][col] = s0;
      red_s[warp][col + 1] = s1;
      red_q[warp][col] = q0;
      red_q[warp][col + 1] = q1;
    }
  }
  __syncthreads();
  const size_t pidx = ((size_t)b * Hout + ho) * gridDim.x + blockIdx.x;
  for (int c = tid; c < COUT; c += CONV_THREADS) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s += red_s[w][c];
      q += red_q[w][c];
    }
    psum[pidx * COUT + c] = s;
    psq[pidx * COUT + c] = q;
  }
}

template <typename TIn, typename TC, int KH, int KW, int S, int P, int COUT>
cudaError_t launch_conv(const TIn* x, const float* mean, const float* rstd, const TC* wt, float* y,
                        float* psum, float* psq, int B, int Hin, int Win, int Hout, int Wout,
                        float slope, cudaStream_t st) {
  constexpr int smem = conv_smem_bytes<TC, KW, S, COUT>();
  auto kernel = conv_in_kernel<TIn, TC, KH, KW, S, P, COUT>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Wout + TM - 1) / TM, Hout, B);
  kernel<<<grid, CONV_THREADS, smem, st>>>(x, mean, rstd, wt, y, psum, psq, Hin, Win, Hout, Wout,
                                           slope);
  return cudaGetLastError();
}

// out = cast(lrelu((y - mean) * rstd)) over one sample's (N / C3, C3) fp32 rows
// per blockIdx.y, four channels per thread.
template <typename TOut>
__global__ void apply_kernel(const float* __restrict__ y, const float* __restrict__ mean,
                             const float* __restrict__ rstd, TOut* __restrict__ out,
                             int per_sample4, float slope) {
  __shared__ float sm[C3], sr[C3];
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C3; c += blockDim.x) {
    sm[c] = mean[b * C3 + c];
    sr[c] = rstd[b * C3 + c];
  }
  __syncthreads();
  const float4* yb = reinterpret_cast<const float4*>(y) + (size_t)b * per_sample4;
  TOut* ob = out + (size_t)b * per_sample4 * 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_sample4; i += gridDim.x * blockDim.x) {
    const float4 v = yb[i];
    const int c = (i * 4) & (C3 - 1);
    const float r[4] = {lrelu((v.x - sm[c]) * sr[c], slope), lrelu((v.y - sm[c + 1]) * sr[c + 1], slope),
                  lrelu((v.z - sm[c + 2]) * sr[c + 2], slope),
                  lrelu((v.w - sm[c + 3]) * sr[c + 3], slope)};
    if constexpr (sizeof(TOut) == 2) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(ob + (size_t)i * 4) = u;
    } else {
      *reinterpret_cast<float4*>(ob + (size_t)i * 4) = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
}

template <typename T>
cudaError_t stem_forward(const T* y1, const T* w2, const T* w3, T* out, float* y2, float* y3,
                         float* psum, float* psq, float* mean, float* rstd, int B, int W1,
                         float slope, cudaStream_t st) {
  const int H2 = (H1 - 2) / 2 + 1, W2 = (W1 - 2) / 2 + 1;
  const int n_wt = (W2 + TM - 1) / TM;
  cudaError_t e;
#define SDT_CHECK(expr)                               \
  if ((e = (expr)) != cudaSuccess) return e

  // IN1 statistics over conv1's output (B, 80, W1, 64)
  row_stats_kernel<T><<<dim3(H1, B), 256, 0, st>>>(y1, psum, psq, H1, W1);
  SDT_CHECK(cudaGetLastError());
  finalize_kernel<<<(B * C1 + 255) / 256, 256, 0, st>>>(psum, psq, mean, rstd, B, H1, C1,
                                                        (float)H1 * W1);
  SDT_CHECK(cudaGetLastError());
  // conv2 on lrelu(IN1(y1)) -> y2 raw, IN2 partials
  SDT_CHECK((launch_conv<T, T, 4, 4, 2, 1, C1>(y1, mean, rstd, w2, y2, psum, psq, B, H1, W1, H2,
                                               W2, slope, st)));
  finalize_kernel<<<(B * C1 + 255) / 256, 256, 0, st>>>(psum, psq, mean, rstd, B, H2 * n_wt,
                                                        C1, (float)H2 * W2);
  SDT_CHECK(cudaGetLastError());
  // conv3 on lrelu(IN2(y2)) -> y3 raw, IN3 partials
  SDT_CHECK((launch_conv<float, T, 3, 3, 1, 1, C3>(y2, mean, rstd, w3, y3, psum, psq, B, H2, W2,
                                                   H2, W2, slope, st)));
  finalize_kernel<<<(B * C3 + 255) / 256, 256, 0, st>>>(psum, psq, mean, rstd, B, H2 * n_wt,
                                                        C3, (float)H2 * W2);
  SDT_CHECK(cudaGetLastError());
  // IN3 + lrelu + cast
  const int per_sample4 = H2 * W2 * C3 / 4;
  const int bx = (per_sample4 + 255) / 256 < 32 ? (per_sample4 + 255) / 256 : 32;
  apply_kernel<T><<<dim3(bx, B), 256, 0, st>>>(y3, mean, rstd, out, per_sample4, slope);
  SDT_CHECK(cudaGetLastError());
#undef SDT_CHECK
  return cudaSuccess;
}

}  // namespace

// y1:  (B, 80, W1, 64) conv1 output, channels last, bf16 if is_bf16 else fp32
// w2:  (4, 4, 64, 64) conv2 weight as (kh, kw, C_out, C_in), same dtype
// w3:  (3, 3, 128, 64) conv3 weight as (kh, kw, C_out, C_in), same dtype
// out: (B, 40, W2, 128) same dtype, W2 = (W1 - 2) / 2 + 1
// scratch (fp32): y2 (B, 40, W2, 64), y3 (B, 40, W2, 128),
//   psum/psq each B * max(80 * 64, 40 * ceil(W2 / 128) * 128), mean/rstd each B * 128
extern "C" int sdt_stem_forward(const void* y1, int is_bf16, const void* w2, const void* w3,
                                void* out, float* y2, float* y3, float* psum, float* psq,
                                float* mean, float* rstd, int B, int W1, float slope,
                                void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16)
    e = stem_forward<bf16>((const bf16*)y1, (const bf16*)w2, (const bf16*)w3, (bf16*)out, y2,
                           y3, psum, psq, mean, rstd, B, W1, slope, st);
  else
    e = stem_forward<float>((const float*)y1, (const float*)w2, (const float*)w3, (float*)out,
                            y2, y3, psum, psq, mean, rstd, B, W1, slope, st);
  return (int)e;
}
