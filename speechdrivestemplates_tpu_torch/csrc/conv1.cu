// Fused conv1 + InstanceNorm + lrelu for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel probes/conv1_pallas.py (_conv1_pallas, body _make_kernel):
// conv1 1->64 k3 s1 p1 as 9 fp32 FMAs per output, InstanceNorm over (h, w) (biased
// variance, eps 1e-5), lrelu, cast to the output dtype. The output is (B, 82, W1, 64),
// channels last, with rows 0 and 81 exactly zero: the activation pre-padded in h for the
// next conv (k4 s2, padding (0, 1)).
//
// What bounds it on an H100: at B=128, W1=427 it reads a 17.5 MB mel and writes a 573.7 MB
// bf16 activation, 0.176 ms at 3.35 TB/s; conv1 is 5.0 GFLOP of fp32 FMAs, 0.075 ms at
// 67 TFLOP/s. So it is bound by its writes.
//
// Design, two launches:
//   1. conv1_gram_kernel, one block per sample. The statistics need no conv: with X_t the
//      zero-padded mel shifted by tap t = 3 dy + dx over the 80 x W1 grid, y_c =
//      sum_t w[c, t] X_t, so sum(y_c) = w_c . S and sum(y_c^2) = w_c' G w_c, where S_t =
//      sum(X_t) (9 sums) and G_tu = sum(X_t X_u) (45 distinct entries): 54 FMAs per pixel in
//      place of 64 x 11. S and G are accumulated in fp64, where the product of two fp32
//      values is exact, so E[y^2] - E[y]^2 loses no digits to cancellation on a mel far from
//      zero mean. The block stages the sample's padded plane in shared memory (137 KB at
//      W1 = 427; 512 columns a pass beyond that) by 4-byte cp.async, every element in flight
//      at once; then a thread walks a column down 20 rows with its 3 x 3 window in
//      registers. Partials are reduced in a fixed order (shuffles, then warps in order): no
//      atomics, deterministic. The block ends by folding the norm into the taps,
//      a[c, t] = w[c, t] * rstd_c and bias_c = -mean_c * rstd_c (fp32), for the apply pass.
//      No separate finalize launch.
//   2. conv1_apply_kernel, one block per (output row, sample) and 2048 columns: out =
//      lrelu(bias + sum_t a[t] X_t), nine fp32 FMAs per output from the bias and the lrelu as
//      a max (min for slope > 1). The block stages the folded taps and its three zero-padded
//      mel rows in shared memory once (its only barrier; the 17.5 MB mel is still in the
//      50 MB L2 from the stats pass), and reads the taps as broadcasts. A thread owns 8
//      channels of 8 adjacent pixels, so its nine vector window loads and 18 tap loads serve
//      64 outputs; eight neighbouring threads write one pixel's 64 channels (128 bytes in
//      bf16) with 16-byte evict-first stores, a warp four full lines per store instruction.
//      (4 pixels a thread, 128- or 256-thread blocks and write-back stores each measured
//      slower on an H100.) The blocks of rows 0 and 81 write zeros.
// No tensor cores: conv1 has one input channel (K = 9).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H1 = 80;             // mel bins = conv1's output height
constexpr int ROWS = H1 + 2;       // output rows: 0 and 81 are zero
constexpr int C = 64;              // conv1 channels
constexpr int TAPS = 9;
constexpr int NG = 45;             // distinct entries of the symmetric 9 x 9 Gram matrix
constexpr int STAT_THREADS = 256;
constexpr int ROW_GROUP = 20;      // rows a stats thread walks down per column
constexpr int GRAM_CW = 512;       // columns of the plane a stats pass stages
constexpr int GRAM_SMEM = ROWS * (GRAM_CW + 2) * 4;
constexpr int APPLY_THREADS = 64;
constexpr int APPLY_CW = 2048;     // output columns per apply block (one block for W <= 2048)
constexpr int PX = 8;              // adjacent pixels per apply thread
constexpr int PGROUPS = APPLY_THREADS / 8;  // pixel groups per block: 8 threads x 8 channels
constexpr float EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4 bytes, or 4 zero bytes when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// index of G_tu, t <= u, in the packed upper triangle
__host__ __device__ constexpr int gidx(int t, int u) { return t * TAPS - t * (t - 1) / 2 + (u - t); }

// Per sample b: S, G in fp64 over the 80 x W output grid; then per channel the mean and
// rstd, written folded into the taps. taps: (B, 10, 64) fp32, rows 0..8 a[t][c], row 9 bias.
// The plane is staged in shared memory GRAM_CW columns at a time (one pass for W <= 512),
// with its zero padding: 82 rows x (cw + 2) columns.
__global__ void __launch_bounds__(STAT_THREADS)
conv1_gram_kernel(const float* __restrict__ mel, const float* __restrict__ w1,
                  float* __restrict__ taps, int W) {
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* plane = mel + (size_t)b * H1 * W;
  extern __shared__ float sp[];  // [ROWS][cw + 2]
  double s[TAPS], g[NG];
#pragma unroll
  for (int i = 0; i < TAPS; ++i) s[i] = 0.0;
#pragma unroll
  for (int i = 0; i < NG; ++i) g[i] = 0.0;

  for (int c0 = 0; c0 < W; c0 += GRAM_CW) {
    const int cw = min(GRAM_CW, W - c0), sw = cw + 2;
    __syncthreads();  // the previous pass is consumed
    // every element in flight at once: a warp per staged row, a lane per column
    for (int r = warp; r < ROWS; r += STAT_THREADS / 32) {
      const int h = r - 1;
      for (int j = lane; j < sw; j += 32) {
        const int wi = c0 - 1 + j;
        const bool ok = h >= 0 && h < H1 && wi >= 0 && wi < W;
        cp_async4_zfill(sp + r * sw + j, ok ? plane + (size_t)h * W + wi : plane, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int items = cw * (H1 / ROW_GROUP);
    for (int item = tid; item < items; item += STAT_THREADS) {
      const int w = item % cw, h0 = (item / cw) * ROW_GROUP;
      // staged row h0 holds mel row h0 - 1, staged column w mel column c0 + w - 1
      const float* col = sp + h0 * sw + w;
      double x[3][3];  // mel rows h-1..h+1, columns w-1..w+1
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) x[dy][dx] = (double)col[dy * sw + dx];
#pragma unroll 2
      for (int h = h0; h < h0 + ROW_GROUP; ++h) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) x[2][dx] = (double)col[(h - h0 + 2) * sw + dx];
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const double xt = x[t / 3][t % 3];
          s[t] += xt;
#pragma unroll
          for (int u = t; u < TAPS; ++u) g[gidx(t, u)] = fma(xt, x[u / 3][u % 3], g[gidx(t, u)]);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          x[0][dx] = x[1][dx];
          x[1][dx] = x[2][dx];
        }
      }
    }
  }

  // fixed-order reduction: butterfly within each warp, then the warps in order
  __shared__ double red[STAT_THREADS / 32][TAPS + NG];
  __shared__ double tot[TAPS + NG];
#pragma unroll
  for (int i = 0; i < TAPS + NG; ++i) {
    double v = i < TAPS ? s[i] : g[i - TAPS];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (tid < TAPS + NG) {
    double v = 0.0;
#pragma unroll
    for (int k = 0; k < STAT_THREADS / 32; ++k) v += red[k][tid];
    tot[tid] = v;
  }
  __syncthreads();
  if (tid < C) {
    const double n = (double)H1 * W;
    double w[TAPS];
#pragma unroll
    for (int t = 0; t < TAPS; ++t) w[t] = (double)w1[tid * TAPS + t];
    double m = 0.0, e2 = 0.0;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      m = fma(w[t], tot[t], m);
#pragma unroll
      for (int u = 0; u < TAPS; ++u)
        e2 = fma(w[t] * w[u], tot[TAPS + (t <= u ? gidx(t, u) : gidx(u, t))], e2);
    }
    m /= n;
    const double var = fmax(e2 / n - m * m, 0.0);
    const float rs = (float)(1.0 / sqrt(var + (double)EPS)), mf = (float)m;
    float* tb = taps + (size_t)b * (TAPS + 1) * C;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) tb[t * C + tid] = w1[tid * TAPS + t] * rs;
    tb[TAPS * C + tid] = -mf * rs;
  }
}

__device__ __forceinline__ void st_cs(void* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}
__device__ __forceinline__ uint32_t f2u(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
  st_cs(dst, f2u(v[0]), f2u(v[1]), f2u(v[2]), f2u(v[3]));
  st_cs(dst + 4, f2u(v[4]), f2u(v[5]), f2u(v[6]), f2u(v[7]));
}
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  st_cs(dst, bf2(v[0], v[1]), bf2(v[2], v[3]), bf2(v[4], v[5]), bf2(v[6], v[7]));
}

// out row r of sample b, columns c0 .. c0 + cw - 1 (c0 = APPLY_CW * blockIdx.z): zeros for
// r = 0 and 81, else cast(lrelu(bias + sum_t a[t] X_t)) of mel row r - 1. MAXF: lrelu(v) =
// max(v, slope v), right for slope <= 1; else min. grid (82, B, ceil(W / APPLY_CW)).
// Dynamic shared memory: the folded taps, then the three mel rows the block reads,
// zero-padded, at a stride of apply_stride(cw) floats.
__host__ __device__ constexpr int apply_stride(int cw) { return (cw + PX - 1) / PX * PX + 4; }
static_assert(PX % 4 == 0, "window loads are float4");

template <typename T, bool MAXF>
__global__ void __launch_bounds__(APPLY_THREADS)
conv1_apply_kernel(const float* __restrict__ mel, const float* __restrict__ taps,
                   T* __restrict__ out, int W, float slope) {
  const int r = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * APPLY_CW, tid = threadIdx.x;
  const int cw = min(APPLY_CW, W - c0);
  T* orow = out + (((size_t)b * ROWS + r) * W + c0) * C;
  if (r == 0 || r == ROWS - 1) {
    const int n = cw * C * (int)sizeof(T) / 16;
    for (int i = tid; i < n; i += APPLY_THREADS) st_cs(reinterpret_cast<uint4*>(orow) + i, 0u, 0u, 0u, 0u);
    return;
  }
  extern __shared__ float4 sdyn[];
  float4 (*sa)[C / 4] = reinterpret_cast<float4 (*)[C / 4]>(sdyn);  // [t][c], row 9 the bias
  float* srow = reinterpret_cast<float*>(sdyn + (TAPS + 1) * C / 4);  // [3][stride]
  const int h = r - 1, stride = apply_stride(cw);
  const float4* tb = reinterpret_cast<const float4*>(taps + (size_t)b * (TAPS + 1) * C);
  for (int i = tid; i < (TAPS + 1) * C / 4; i += APPLY_THREADS) sa[i / (C / 4)][i % (C / 4)] = tb[i];
  // staged column j holds mel column c0 - 1 + j; zero outside the mel
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int hi = h - 1 + dy;
    const float* src = mel + ((size_t)b * H1 + (hi >= 0 && hi < H1 ? hi : 0)) * W;
    for (int j = tid; j < stride; j += APPLY_THREADS) {
      const int wi = c0 - 1 + j;
      const bool ok = hi >= 0 && hi < H1 && wi >= 0 && wi < W;
      cp_async4_zfill(srow + dy * stride + j, ok ? src + wi : src, ok);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the block's only barrier

  const int cq = (tid & 7) * 2, pg = tid >> 3;  // channels 4 cq .. 4 cq + 7
  const float4 bias0 = sa[TAPS][cq], bias1 = sa[TAPS][cq + 1];
  for (int p0 = pg * PX; p0 < cw; p0 += PGROUPS * PX) {
    float x[3][PX + 2];  // staged columns p0 .. p0 + PX + 1 = mel columns c0 + p0 - 1 ..
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* sr = srow + dy * stride + p0;
#pragma unroll
      for (int j = 0; j < PX; j += 4) {
        const float4 u = *reinterpret_cast<const float4*>(sr + j);
        x[dy][j] = u.x; x[dy][j + 1] = u.y; x[dy][j + 2] = u.z; x[dy][j + 3] = u.w;
      }
      const float2 v = *reinterpret_cast<const float2*>(sr + PX);
      x[dy][PX] = v.x; x[dy][PX + 1] = v.y;
    }
    float acc[PX][8];
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      acc[p][0] = bias0.x; acc[p][1] = bias0.y; acc[p][2] = bias0.z; acc[p][3] = bias0.w;
      acc[p][4] = bias1.x; acc[p][5] = bias1.y; acc[p][6] = bias1.z; acc[p][7] = bias1.w;
    }
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const float4 t0 = sa[t][cq], t1 = sa[t][cq + 1];
      const float a[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const float xv = x[t / 3][p + t % 3];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[p][e] = fmaf(xv, a[e], acc[p][e]);
      }
    }
#pragma unroll
    for (int p = 0; p < PX; ++p) {
      if (p0 + p < cw) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[p][e] = MAXF ? fmaxf(acc[p][e], slope * acc[p][e]) : fminf(acc[p][e], slope * acc[p][e]);
        store8(orow + (size_t)(p0 + p) * C + cq * 4, acc[p]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_apply(const float* mel, const float* taps, T* out, int B, int W, float slope,
                         cudaStream_t st) {
  const dim3 grid(ROWS, B, (W + APPLY_CW - 1) / APPLY_CW);
  const int smem = (TAPS + 1) * C * 4 + 3 * apply_stride(W < APPLY_CW ? W : APPLY_CW) * 4;  // < 48 KB
  if (slope <= 1.f)
    conv1_apply_kernel<T, true><<<grid, APPLY_THREADS, smem, st>>>(mel, taps, out, W, slope);
  else
    conv1_apply_kernel<T, false><<<grid, APPLY_THREADS, smem, st>>>(mel, taps, out, W, slope);
  return cudaGetLastError();
}

}  // namespace

// mel:  (B, 80, W1) fp32, contiguous
// w1:   (64, 1, 3, 3) fp32 conv1 weight, OIHW, contiguous
// out:  (B, 82, W1, 64), bf16 if is_bf16 else fp32
// taps: fp32 scratch of B * 10 * 64 (the folded taps and bias per sample)
extern "C" int sdt_conv1_in_forward(const float* mel, const float* w1, void* out, int is_bf16,
                                    float* taps, int B, int W1, float slope, void* stream) {
  if (B <= 0 || W1 <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  static bool configured = false;  // one attribute call
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv1_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GRAM_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int gram_smem = ROWS * ((W1 < GRAM_CW ? W1 : GRAM_CW) + 2) * 4;
  conv1_gram_kernel<<<B, STAT_THREADS, gram_smem, st>>>(mel, w1, taps, W1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)(is_bf16 ? launch_apply<bf16>(mel, taps, (bf16*)out, B, W1, slope, st)
                       : launch_apply<float>(mel, taps, (float*)out, B, W1, slope, st));
}
