// Eval-mode InstanceNorm + leaky ReLU + the cast to the compute dtype in one pass, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package leaves the IN layers after the stem to XLA, which
// fuses them. The port's plain path (models/blocks.py: instance_norm_2d or channel_norm_1d,
// F.leaky_relu, .to(dtype)) runs them as separate passes over the whole activation: a cast up
// to fp32, a var_mean reduction, the subtract, the rsqrt multiply, the lrelu and a cast down.
//
// What it computes: the 2-D IN (each (b, c) plane over H x W) and the 1-D channel norm (each
// (b, t) column over C) are one operation, the normalization of each column of a dense
// (N, R, K) slab over R, K the contiguous axis:
//   channels-last (B, C, H, W), as cuDNN leaves layers 3-7:  N = B, R = H x W, K = C
//   contiguous (B, C, H, W), the row form:                    N = B x C, R = H x W, K = 1
//   contiguous (B, C, T), the 1-D layers:                     N = B, R = C, K = T
// Per column, in fp32 from the bf16 or fp32 values: the mean and the biased variance by
// Welford's update over a thread's rows and Chan's merge across threads (cancellation-safe,
// as var_mean's own reduction), rstd = rsqrtf(var + 1e-5); then, per element, each step one
// fp32 operation rounded where the plain path rounds it, none contracted into an FMA:
//   y = cast(lrelu((x - mean) * rstd)),   lrelu(t) = t > 0 ? t : t * slope
// The summation order is not var_mean's, so the statistics differ from it by a few fp32 ulps,
// and an output by one bf16 ulp at a rounding boundary plus that round-off (near a column's
// mean, where x - mean cancels, many bf16 ulps of a value near 0).
//
// What bounds it on an H100: bytes. SDT-BP's 21 IN layers after the stem at B = 128 hold
// 165,969,920 elements, read once and written once in bf16: 664 MB, 0.198 ms at 3.35 TB/s.
// The statistics need every element before any output, so the design keeps the second read
// off device memory:
//   - A column tile is KT columns (a power of two times the vector, up to 128 bytes a row:
//     narrower rows read slower) over all R rows. A thread owns a vector of VEC adjacent
//     columns (16 bytes: 8 bf16 or 4 fp32) and walks every (THREADS / lanes)-th row, UNROLL
//     loads in flight; a warp reads whole row segments.
//   - A tile's rows split over a cluster of 1 to 8 blocks until a block's share fits in
//     SLAB_BYTES of shared memory: layers 3-4 (2,120 rows of 128 bytes) over 4 blocks of 68
//     KB, layers 5-7 and the 1-D layers in one block. The first pass parks each vector
//     there and the apply pass reads it back; each thread re-reads only what it parked, so
//     no barrier guards the slab. Registers (68 a thread at bf16) allow three blocks an SM.
//     Where even 8 blocks' shares do not fit at one vector's width (over 51,200 rows), the
//     apply pass reads the tile again from device memory, most of it from L2.
//   - A tile's statistics: Welford over a thread's rows (one reciprocal a row: the count is
//     the thread's, shared by its columns), a butterfly of shuffles inside a warp, the
//     warps' partials in shared memory, then the cluster's blocks' partials read through
//     distributed shared memory, each merge by Chan's formula in a fixed order: every block
//     of a cluster holds the same statistics, and they do not depend on scheduling.
//   - Splitting rows further to fill the card with blocks made it slower (the 1-D layers'
//     blocks are a few KB, and a cluster's two barriers cost more than the work): the
//     measured variants are in PERF.md.
// A pointer that is not 16-byte aligned, or K not a multiple of VEC, takes VEC = 1. No
// allocation and no synchronisation outside a cluster: the launch is safe to capture in a
// CUDA graph. Optionally the tile's first block writes each column's mean and variance
// (tests hold them to var_mean's).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr float EPS = 1e-5f;       // models/blocks.py NORM_EPS
constexpr int ROW_BYTES = 128;     // a column tile's widest row segment
constexpr int KT_MAX = 64;         // columns of a tile (bf16 at 128 bytes; one element a lane)
constexpr uint32_t CLUSTER_MAX = 8;  // blocks a tile's rows may split over (portable cluster)
constexpr uint32_t SLAB_BYTES = 100 * 1024;  // shared memory a block may park its rows in

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// what a thread loads and stores at once: 16 bytes, or one element
template <typename T, int VEC> struct VecOf { typedef uint4 type; };
template <typename T> struct VecOf<T, 1> { typedef T type; };

struct Params {
  uint32_t R, K, KT, ktiles, lanes_log2;  // lanes = KT / VEC vectors a row, a power of two
  uint32_t cluster, rows;                 // blocks a tile's rows split over, rows a block
  int cached;
  float slope;
  float* mean_out;  // N x K each, or null
  float* var_out;
};

// Chan's merge of (nb, mb, qb) into (n, m, q) for VEC columns that share their counts
template <int VEC>
__device__ __forceinline__ void merge(float& n, float* m, float* q, float nb, const float* mb,
                                      const float* qb) {
  const float nab = n + nb;
  if (nb == 0.f) return;
  const float wb = __fdiv_rn(nb, nab);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = mb[i] - m[i];
    m[i] += d * wb;
    q[i] += qb[i] + d * d * n * wb;
  }
  n = nab;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
in_act_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p) {
  typedef typename VecOf<T, VEC>::type V;
  static_assert(sizeof(V) == VEC * sizeof(T), "a vector is VEC elements");
  extern __shared__ uint4 slab_raw[];
  V* slab = reinterpret_cast<V*>(slab_raw);
  __shared__ float part_m[WARPS][KT_MAX], part_q[WARPS][KT_MAX], part_n[WARPS];
  __shared__ float blk_m[KT_MAX], blk_q[KT_MAX], blk_n;  // the block's rows, read by its cluster
  __shared__ float col_mean[KT_MAX], col_rstd[KT_MAX];

  const uint32_t tile = blockIdx.x / p.cluster, rank = blockIdx.x % p.cluster;
  const uint32_t n_idx = tile / p.ktiles, k0 = (tile % p.ktiles) * p.KT;
  const uint32_t r_lo = rank * p.rows, r_hi = min(p.R, r_lo + p.rows);
  const uint32_t lanes = 1u << p.lanes_log2, rows_apart = THREADS >> p.lanes_log2;
  const uint32_t g = threadIdx.x & (lanes - 1), r_first = r_lo + (threadIdx.x >> p.lanes_log2);
  const uint32_t col = k0 + g * VEC;
  const bool active = col < p.K;
  const size_t base = (size_t)n_idx * p.R * p.K + col;
  const V* xs = reinterpret_cast<const V*>(x + base);  // row r at xs + r * (K / VEC)
  V* ys = reinterpret_cast<V*>(y + base);
  const uint32_t stride = p.K / VEC;

  // pass 1: Welford over the thread's rows, parking each vector in the slab
  float cnt = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) mean[i] = m2[i] = 0.f;
  for (uint32_t r0 = r_first; r0 < r_hi; r0 += UNROLL * rows_apart) {
    V in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t r = r0 + u * rows_apart;
      in[u] = V();
      if (active && r < r_hi) in[u] = xs[(size_t)r * stride];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t r = r0 + u * rows_apart;
      if (r >= r_hi) break;
      if (p.cached) slab[(r - r_lo) * lanes + g] = in[u];
      cnt += 1.f;
      const float inv = __frcp_rn(cnt);
      const T* a = reinterpret_cast<const T*>(&in[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f32(a[i]);
        const float d = v - mean[i];
        mean[i] += d * inv;
        m2[i] += d * (v - mean[i]);
      }
    }
  }

  // merge: the lanes of a warp that hold the same columns, the warps in order, then the
  // cluster's blocks in rank order (every block merges the same partials alike)
  for (uint32_t off = lanes; off < 32; off <<= 1) {
    float mb[VEC], qb[VEC];
    const float nb = __shfl_xor_sync(0xffffffffu, cnt, off);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mb[i] = __shfl_xor_sync(0xffffffffu, mean[i], off);
      qb[i] = __shfl_xor_sync(0xffffffffu, m2[i], off);
    }
    merge<VEC>(cnt, mean, m2, nb, mb, qb);
  }
  const uint32_t warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < lanes) {  // lanes <= 32: one row of lanes a warp holds the warp's sums
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      part_m[warp][g * VEC + i] = mean[i];
      part_q[warp][g * VEC + i] = m2[i];
    }
    if (lane == 0) part_n[warp] = cnt;
  }
  __syncthreads();
  const uint32_t j = threadIdx.x;
  if (j < p.KT) {
    float n = 0.f, m = 0.f, q = 0.f;
    for (int w = 0; w < WARPS; ++w) merge<1>(n, &m, &q, part_n[w], &part_m[w][j], &part_q[w][j]);
    blk_m[j] = m;
    blk_q[j] = q;
    if (j == 0) blk_n = n;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials written (a block barrier where the cluster is one)
  if (j < p.KT) {
    float n = 0.f, m = 0.f, q = 0.f;
    for (uint32_t b = 0; b < p.cluster; ++b)
      merge<1>(n, &m, &q, *cluster.map_shared_rank(&blk_n, b),
               cluster.map_shared_rank(&blk_m[j], b), cluster.map_shared_rank(&blk_q[j], b));
    const float var = __fdiv_rn(q, n);
    col_mean[j] = m;
    col_rstd[j] = rsqrtf(__fadd_rn(var, EPS));
    if (p.mean_out != nullptr && rank == 0 && k0 + j < p.K) {
      p.mean_out[(size_t)n_idx * p.K + k0 + j] = m;
      p.var_out[(size_t)n_idx * p.K + k0 + j] = var;
    }
  }
  cluster.sync();  // every block done reading the others' partials before any exits
  if (!active) return;

  // pass 2: normalize, lrelu, cast, from the slab (the thread's own vectors) or again from x
  float cm[VEC], cr[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    cm[i] = col_mean[g * VEC + i];
    cr[i] = col_rstd[g * VEC + i];
  }
  for (uint32_t r0 = r_first; r0 < r_hi; r0 += UNROLL * rows_apart) {
    V in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t r = r0 + u * rows_apart;
      if (r < r_hi) in[u] = p.cached ? slab[(r - r_lo) * lanes + g] : xs[(size_t)r * stride];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t r = r0 + u * rows_apart;
      if (r >= r_hi) break;
      const T* a = reinterpret_cast<const T*>(&in[u]);
      V out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float t = __fmul_rn(__fsub_rn(to_f32(a[i]), cm[i]), cr[i]);
        o[i] = from_f32<T>(t > 0.f ? t : __fmul_rn(t, p.slope));
      }
      ys[(size_t)r * stride] = out;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, T* y, uint32_t N, Params p, cudaStream_t stream) {
  static bool configured = false;  // one attribute call an instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        in_act_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SLAB_BYTES);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // the widest tile up to 128-byte rows that K needs; its rows split over a cluster of up
  // to CLUSTER_MAX blocks until a block's share fits in shared memory, then the tile narrows
  uint32_t kt = VEC, cs = 1;
  const uint32_t kt_max = VEC == 1 ? 32 : ROW_BYTES / sizeof(T);
  while (kt < p.K && 2 * kt <= kt_max) kt *= 2;
  auto share = [&](uint32_t c) { return (p.R + c - 1) / c; };
  auto fits = [&]() { return (size_t)share(cs) * kt * sizeof(T) <= SLAB_BYTES; };
  while (!fits() && (cs < CLUSTER_MAX || kt > VEC)) {
    if (cs < CLUSTER_MAX) cs *= 2;
    else kt /= 2;
  }
  p.KT = kt;
  p.ktiles = (p.K + kt - 1) / kt;
  p.cluster = cs;
  p.rows = share(cs);
  for (p.lanes_log2 = 0; (1u << p.lanes_log2) < kt / VEC; ++p.lanes_log2) {}
  p.cached = fits();
  const size_t blocks = (size_t)N * p.ktiles * cs;
  if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((uint32_t)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.cached ? (size_t)p.rows * kt * sizeof(T) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, in_act_kernel<T, VEC>, x, y, p);
}

template <typename T>
cudaError_t launch(const T* x, T* y, uint32_t N, const Params& p, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (aligned && p.K % VEC == 0) return launch_vec<T, VEC>(x, y, N, p, stream);
  return launch_vec<T, 1>(x, y, N, p, stream);
}

}  // namespace

// x, y: a dense (N, R, K) slab, K contiguous, bf16 (is_bf16) or fp32, R * K under 2^31;
// mean_out, var_out: N * K fp32 each, or both null. Normalizes each of the N x K columns over
// its R rows. Returns the launch error, cudaErrorInvalidValue for a shape it does not take.
extern "C" int sdt_in_act_forward(const void* x, void* y, float* mean_out, float* var_out,
                                  int is_bf16, int N, int R, int K, float slope, void* stream) {
  if (N < 0 || R < 1 || K < 1 || (int64_t)R * K > 0x7fffffff ||
      (mean_out == nullptr) != (var_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const Params p{(uint32_t)R, (uint32_t)K, 0, 0, 0, 0, 0, 0, slope, mean_out, var_out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch(static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                (uint32_t)N, p, st)
                       : launch(static_cast<const float*>(x), static_cast<float*>(y),
                                (uint32_t)N, p, st));
}
