// Fused conv1 + InstanceNorm + lrelu for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel probes/conv1_pallas.py (_conv1_pallas, body _make_kernel):
// conv1 1->64 k3 s1 p1 as 9 fp32 FMAs per output, InstanceNorm over (h, w) in fp32
// (biased variance E[x^2] - E[x]^2, eps 1e-5), lrelu, cast to the output dtype. The output
// is (B, 82, W1, 64), channels last, with rows 0 and 81 exactly zero: the activation
// pre-padded in h for the next conv (k4 s2, padding (0, 1)).
//
// What bounds it on an H100: at B=128, W1=427 it reads a 17.5 MB mel and writes a 573.7 MB
// bf16 activation, 0.176 ms at 3.35 TB/s; conv1 is 5.0 GFLOP of fp32 FMAs, 0.075 ms at
// 67 TFLOP/s. So it is bound by its writes.
//
// Design. The TPU kernel held a sample's whole 82 x 427 x 64 plane in VMEM. Here a block
// owns one (sample, row) and the norm needs a cross-block reduction, so three launches:
//   1. stats: per (sample, row), the block stages the three mel rows its taps read, TW
//      columns at a time, in shared memory, zero outside the mel (conv1's padding is zero
//      MEL, before the norm). A thread keeps 8 channels' 9 taps in registers and computes
//      conv1 for those 8 channels of one pixel at a time; channel sums and sums of squares
//      over the row's valid pixels are reduced in a fixed order (no atomics).
//   2. finalize: per (sample, channel) the 80 row partials summed in order into mean and
//      1/sqrt(var + eps): deterministic.
//   3. apply: recomputes conv1 (~0.075 ms of FMAs, against 1.1 GB to store it raw in fp32
//      and read it back), normalizes, applies lrelu and casts. Eight neighbouring threads
//      write one pixel's 64 channels (128 bytes in bf16) with 16-byte stores, so a warp
//      writes 512 contiguous bytes. The blocks of rows 0 and 81 write zeros.
// No tensor cores: conv1 has one input channel (K = 9).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H1 = 80;            // mel bins = conv1's output height
constexpr int ROWS = H1 + 2;      // output rows: 0 and 81 are zero
constexpr int C = 64;             // conv1 channels
constexpr int THREADS = 256;
constexpr int PIX = THREADS / 8;  // pixels per pass: 8 threads x 8 channels each
constexpr int TW = 4 * PIX;       // columns staged at a time
constexpr float EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : slope * v; }

// mel rows h-1..h+1, columns w0-1 .. w0+TW of sample b into s, zero outside the mel
__device__ __forceinline__ void stage_rows(const float* __restrict__ mel, float (*s)[TW + 2],
                                           int b, int h, int w0, int W) {
  for (int i = threadIdx.x; i < 3 * (TW + 2); i += THREADS) {
    const int dy = i / (TW + 2), j = i % (TW + 2);
    const int hi = h - 1 + dy, wi = w0 - 1 + j;
    s[dy][j] = (hi >= 0 && hi < H1 && wi >= 0 && wi < W)
                   ? mel[((size_t)b * H1 + hi) * W + wi]
                   : 0.f;
  }
}

// the 9 taps of channels c0..c0+7 from the OIHW (64, 1, 3, 3) weight
__device__ __forceinline__ void load_taps(const float* __restrict__ w1, int c0, float (*w)[8]) {
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) w[t][e] = w1[(c0 + e) * 9 + t];
}

// conv1 of 8 channels at staged column p (output column w0 + p), taps in (dy, dx) order
__device__ __forceinline__ void conv8(const float (*s)[TW + 2], const float (*w)[8], int p,
                                      float* acc) {
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float x = s[dy][p + dx];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(x, w[3 * dy + dx][e], acc[e]);
    }
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// Per-(sample, row h, channel) sums and sums of squares of conv1's output.
// grid (80, B); psum/psq: (B, 80, 64).
__global__ void __launch_bounds__(THREADS)
conv1_stats_kernel(const float* __restrict__ mel, const float* __restrict__ w1,
                   float* __restrict__ psum, float* __restrict__ psq, int W) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, c0 = (tid & 7) * 8, px = tid >> 3;
  const int warp = tid >> 5, lane = tid & 31;
  __shared__ float s[3][TW + 2];
  __shared__ float red_s[THREADS / 32][C], red_q[THREADS / 32][C];
  float w[9][8];
  load_taps(w1, c0, w);
  float sum[8], sq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = sq[e] = 0.f;

  for (int w0 = 0; w0 < W; w0 += TW) {
    __syncthreads();  // the previous chunk is consumed
    stage_rows(mel, s, b, h, w0, W);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TW / PIX; ++k) {
      const int p = px + k * PIX;
      if (w0 + p < W) {  // only valid pixels enter the statistics
        float acc[8];
        conv8(s, w, p, acc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum[e] += acc[e];
          sq[e] = fmaf(acc[e], acc[e], sq[e]);
        }
      }
    }
  }
  // over the warp's 4 pixels that hold the same channels (lanes 8 apart)
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int off = 8; off < 32; off <<= 1) {
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
      sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], off);
    }
  if (lane < 8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red_s[warp][c0 + e] = sum[e];
      red_q[warp][c0 + e] = sq[e];
    }
  }
  __syncthreads();
  if (tid < C) {
    float s_ = 0.f, q_ = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      s_ += red_s[i][tid];
      q_ += red_q[i][tid];
    }
    const size_t o = ((size_t)b * H1 + h) * C + tid;
    psum[o] = s_;
    psq[o] = q_;
  }
}

// Sum the 80 row partials per (sample, channel) in order; mean and 1/sqrt(var + eps).
__global__ void conv1_finalize_kernel(const float* __restrict__ psum,
                                      const float* __restrict__ psq, float* __restrict__ mean,
                                      float* __restrict__ rstd, int B, float n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s = 0.f, q = 0.f;
  for (int h = 0; h < H1; ++h) {
    const size_t o = ((size_t)b * H1 + h) * C + c;
    s += psum[o];
    q += psq[o];
  }
  const float m = s / n;
  mean[i] = m;
  rstd[i] = rsqrtf(q / n - m * m + EPS);
}

// out row r of sample b: zeros for r = 0 and 81, else cast(lrelu(IN(conv1))) of mel row
// r - 1. grid (82, B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1_apply_kernel(const float* __restrict__ mel, const float* __restrict__ w1,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   T* __restrict__ out, int W, float slope) {
  const int r = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, c0 = (tid & 7) * 8, px = tid >> 3;
  T* orow = out + ((size_t)b * ROWS + r) * W * C;
  if (r == 0 || r == ROWS - 1) {
    uint4* o = reinterpret_cast<uint4*>(orow);
    const int n = W * C * (int)sizeof(T) / 16;
    for (int i = tid; i < n; i += THREADS) o[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int h = r - 1;
  __shared__ float s[3][TW + 2];
  float w[9][8], m[8], rs[8];
  load_taps(w1, c0, w);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = mean[b * C + c0 + e];
    rs[e] = rstd[b * C + c0 + e];
  }
  for (int w0 = 0; w0 < W; w0 += TW) {
    __syncthreads();
    stage_rows(mel, s, b, h, w0, W);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TW / PIX; ++k) {
      const int p = px + k * PIX, wi = w0 + p;
      if (wi < W) {
        float v[8];
        conv8(s, w, p, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = lrelu((v[e] - m[e]) * rs[e], slope);
        store8(orow + (size_t)wi * C + c0, v);
      }
    }
  }
}

}  // namespace

// mel:  (B, 80, W1) fp32, contiguous
// w1:   (64, 1, 3, 3) fp32 conv1 weight, OIHW, contiguous
// out:  (B, 82, W1, 64), bf16 if is_bf16 else fp32
// scratch (fp32): psum/psq each B * 80 * 64, mean/rstd each B * 64
extern "C" int sdt_conv1_in_forward(const float* mel, const float* w1, void* out, int is_bf16,
                                    float* psum, float* psq, float* mean, float* rstd, int B,
                                    int W1, float slope, void* stream) {
  if (B <= 0 || W1 <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  conv1_stats_kernel<<<dim3(H1, B), THREADS, 0, st>>>(mel, w1, psum, psq, W1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  conv1_finalize_kernel<<<(B * C + 255) / 256, 256, 0, st>>>(psum, psq, mean, rstd, B,
                                                             (float)H1 * W1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (is_bf16)
    conv1_apply_kernel<bf16><<<dim3(ROWS, B), THREADS, 0, st>>>(mel, w1, mean, rstd, (bf16*)out,
                                                                W1, slope);
  else
    conv1_apply_kernel<float><<<dim3(ROWS, B), THREADS, 0, st>>>(mel, w1, mean, rstd,
                                                                 (float*)out, W1, slope);
  return (int)cudaGetLastError();
}
