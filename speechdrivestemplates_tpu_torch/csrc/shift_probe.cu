// Tap-shift probe for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel of bench_profile.py's profile_shift_probe (pallas_call in its inner
// `call`, bodies k_aligned and k_subtile): a 9-tap conv-as-matmul on flat planes,
//     out[n, m] = bf16(sum_t x[n, m + off_t] @ w[t])   for m < M_out,
// with fp32 accumulation; off_t = 0 ("aligned") or t ("subtile"). No boundary handling: the
// caller keeps M_out + 8 <= M for subtile. It measures what reading nine row-shifted views of
// one staged window costs next to reading the same view nine times.
//
// What bounds it on an H100: at (128, 4480, 128) x (9, 128, 128) it is 152.2 GFLOP, 0.154 ms
// at the 989 TFLOP/s bf16 dense peak, and moves 279 MB, 0.083 ms at 3.35 TB/s. Operations
// bound it.
//
// Design: persistent blocks on wgmma with the weights resident in shared memory.
//   - A CTA owns 64 output columns and keeps the nine (C_in x 64) weight tiles of its columns
//     resident for the whole launch, loaded once (transposed to K-major on the way) in the
//     wgmma B layout with the 128-byte swizzle: C_in = 64 channels are one 128-byte row per
//     output column, C_in = 128 two such blocks (K halves). At C = 128 the nine full tiles
//     (288 KB) do not fit one CTA, so a cluster of 2 CTAs splits the columns (144 KB each);
//     at C = 64 (72 KB) the cluster is one CTA. The two CTAs of a cluster walk the same
//     sequence of (plane, 128-row) tiles on neighbouring SMs, so the second read of each
//     window hits L2. Each block takes every gridDim-th tile; the grid is as many clusters
//     as can be resident at once.
//   - A producer warpgroup stages each tile's window of x, TM + 8 rows (subtile) or TM rows
//     (aligned) x C channels, by cp.async into a ring (2 stages at C = 128, 4 at C = 64)
//     guarded by "full" and "empty" mbarriers; rows beyond M are zero-filled (they feed only
//     masked outputs). The window is kept as 128-byte rows per 64-channel half, 16-byte
//     chunks XOR-swizzled by the row index.
//   - Two consumer warpgroups own 64 of the tile's rows each and run wgmma.m64n64k16 with B
//     from the resident weights by descriptor and A from registers: ldmatrix reads a tap's
//     fragments from the window at row offset t (subtile) or 0, so a shift of one row is only
//     an address, and the swizzle of the row actually read keeps its eight rows in distinct
//     banks. Subtile double-buffers the A fragments: tap t + 1's are loaded while tap t's
//     products run. Aligned loads them once and reuses them for all nine taps.
//   - The epilogue casts to bf16 and writes 8-byte pieces (neighbouring lanes trade halves);
//     the producer meanwhile fills the next window.
// No TMA and no multicast yet: each CTA of a cluster stages the window itself.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int TM = 128;            // output rows per tile: two consumer warpgroups x 64
constexpr int NCOL = 64;           // output columns per CTA
constexpr int WARPS = 8;           // consumer warps
constexpr int CONS_THREADS = WARPS * 32;
constexpr int PROD_THREADS = 128;  // one producer warpgroup
constexpr int THREADS = CONS_THREADS + PROD_THREADS;

typedef __nv_bfloat16 bf16;

template <int C, bool SHIFT>
struct Plan {
  static constexpr int KH = C / 64;                       // 64-channel halves of K
  static constexpr int CLUSTER = C / NCOL;                // CTAs per cluster
  static constexpr int WROWS = TM + (SHIFT ? TAPS - 1 : 0);
  static constexpr int STAGES = C == 128 ? 2 : 4;
  static constexpr int W_BYTES = TAPS * KH * NCOL * 128;  // resident weights
  static constexpr int HALF_BYTES = WROWS * 128;          // one K half of a window
  static constexpr int STAGE_BYTES = KH * HALF_BYTES;
  static constexpr int RING_OFF = W_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;  // full, empty [STAGES]
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;     // + alignment slack
  static_assert(SMEM <= 232448, "one block per SM");
  static_assert(W_BYTES % 1024 == 0 && HALF_BYTES % 1024 == 0, "1024-byte swizzle atoms");
};

// ---- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t swz(int row, int chunk, int key) {
  return (uint32_t)(row * 128 + ((chunk ^ (key & 7)) << 4));
}
// 16 bytes, or 16 zero bytes when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@!P1 bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive on bar once all of this thread's earlier cp.async have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// writes of the generic proxy (st.shared) visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of accumulators across a fence or wait
__device__ __forceinline__ void fence_acc(float (*d)[4]) {
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// Shared-memory descriptor of a K-major bf16 operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), 1024-byte aligned.
// Advancing K by 16 elements adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// D (64 x 64 fp32, in registers) += A (64 x 16 bf16, in registers: per warp the
// m16n8k16 A fragment of its 16 rows) x B (16 x 64, shared, descriptor); the
// accumulator of each warp is mma.sync's m16n8 C layout, one n8 tile per d[j].
__device__ __forceinline__ void wgmma_m64n64k16(float (*d)[4], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
}

// x: (N, M, C) bf16; w: (9, C_in, C_out) bf16; out: (N, M_out, C) bf16.
// Tile i = (plane i / n_mt, rows (i % n_mt) * TM ...); cluster k takes tiles k, k + nclusters, ...
template <int C, bool SHIFT>
__global__ void __launch_bounds__(THREADS, 1)
shift_taps_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                  int M, int M_out, int n_mt, int n_tiles) {
  using L = Plan<C, SHIFT>;
  constexpr int KS = C / 16;  // k16 steps per tap
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sw = smem_u32(base);  // resident weights at sw
  const uint32_t sring = sw + L::RING_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = L::CLUSTER > 1 ? (int)cluster_ctarank() : 0;
  const int first = (int)cluster_id(), step = (int)cluster_count();

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], PROD_THREADS);  // one arrival per producer thread
      mbar_init(&empty[s], WARPS);        // one arrival per consumer warp
    }
  }
  // this CTA's 64 columns of the nine taps, transposed to K-major: element (t, k, n) of w
  // lands in row (t * KH + k / 64) * 64 + n, 16-byte chunk (k % 64) / 8 swizzled by n
  for (int i = tid; i < TAPS * C * (NCOL / 8); i += THREADS) {
    const int t = i / (C * (NCOL / 8)), k = (i / (NCOL / 8)) % C, nc = i % (NCOL / 8);
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(w + ((size_t)t * C + k) * C + rank * NCOL + nc * 8));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    const int row0 = (t * L::KH + k / 64) * NCOL;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nc * 8 + j;
      *reinterpret_cast<bf16*>(base + swz(row0 + n, (k % 64) / 8, n) + (k % 8) * 2) = e[j];
    }
  }
  fence_proxy_async();  // wgmma reads the weights through the async proxy
  __syncthreads();

  if (warp >= WARPS) {  // ---- producer: the windows of this cluster's tiles, in order ----
    const int ptid = tid - CONS_THREADS;
    int it = 0;
    for (int tile = first; tile < n_tiles; tile += step, ++it) {
      const int n = tile / n_mt, m0 = (tile % n_mt) * TM;
      const int stage = it % L::STAGES;
      mbar_wait(&empty[stage], ((it / L::STAGES) & 1) ^ 1);
      const bf16* xn = x + (size_t)n * M * C;
      const uint32_t dst = sring + stage * L::STAGE_BYTES;
      for (int i = ptid; i < L::WROWS * L::KH * 8; i += PROD_THREADS) {
        const int r = i / (L::KH * 8), kh = (i / 8) % L::KH, c = i % 8;
        const bool ok = m0 + r < M;
        cp_async16_zfill(dst + kh * L::HALF_BYTES + swz(r, c, r),
                         ok ? xn + (size_t)(m0 + r) * C + kh * 64 + c * 8 : x, ok);
      }
      mbar_arrive_cp_async(&full[stage]);
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumers: two warpgroups x 64 rows x this CTA's 64 columns ----
  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  // ldmatrix lane roles (A): window row lrow of the warp's 16, channel chunk 2 ks + asel
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, asel = lane >> 4;
  const int q0 = warp * 16 + lrow;
  int it = 0;
  for (int tile = first; tile < n_tiles; tile += step, ++it) {
    const int n = tile / n_mt, m0 = (tile % n_mt) * TM;
    const int stage = it % L::STAGES;
    const bool active = m0 + wg * 64 < M_out;  // per warpgroup: wgmma is collective
    mbar_wait(&full[stage], (it / L::STAGES) & 1);
    const uint32_t ring = sring + stage * L::STAGE_BYTES;
    // the A fragments of all k16 steps at window row offset off
    auto load_a = [&](uint32_t(*a)[4], int off) {
      const int q = q0 + off;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(a[ks], ring + (ks / 4) * L::HALF_BYTES + swz(q, 2 * (ks % 4) + asel, q));
    };
    auto products = [&](float(*acc)[4], uint32_t(*a)[4], int t) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_m64n64k16(acc, a[ks],
                        desc_sw128(sw + (t * L::KH + ks / 4) * NCOL * 128) + 2 * (ks % 4));
    };
    auto release = [&]() {  // the window is in registers: hand the stage back
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    if (!active) {
      release();
      continue;
    }
    float acc[NCOL / 8][4];
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    fence_acc(acc);
    if constexpr (SHIFT) {
      uint32_t a[2][KS][4];
      load_a(a[0], 0);
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        wgmma_fence();
        products(acc, a[t & 1], t);
        wgmma_commit();
        if (t + 1 < TAPS) {
          wgmma_wait<1>();  // tap t - 1's products, the last readers of a[(t + 1) & 1], are done
          load_a(a[(t + 1) & 1], t + 1);
        }
      }
    } else {
      uint32_t a[KS][4];
      load_a(a, 0);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < TAPS; ++t) products(acc, a, t);
      wgmma_commit();
    }
    release();
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: rows g and g + 8 of the warp's 16; lanes tig and tig ^ 1 trade halves so
    // that each writes 4 consecutive columns (8 bytes) of one n8 tile
    const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
    bf16* on = out + (size_t)n * M_out * C + rank * NCOL;
    const bool odd = tig & 1;
#pragma unroll
    for (int j = 0; j < NCOL / 8; j += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(acc[j + 1][2 * h], acc[j + 1][2 * h + 1]);
        const uint32_t w0u = *reinterpret_cast<const uint32_t*>(&p0);
        const uint32_t w1u = *reinterpret_cast<const uint32_t*>(&p1);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0u : w1u, 1);
        const uint2 u = odd ? make_uint2(got, w1u) : make_uint2(w0u, got);
        const int r = h ? r1 : r0;
        if (r < M_out)
          *reinterpret_cast<uint2*>(&on[(size_t)r * C + (j + odd) * 8 + (tig >> 1) * 4]) = u;
      }
    }
  }
}

template <int C, bool SHIFT>
cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int N, int M, int M_out,
                   cudaStream_t st) {
  using L = Plan<C, SHIFT>;
  auto kernel = shift_taps_kernel<C, SHIFT>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int max_clusters = 0;  // clusters resident at once; one query per instantiation
  if (max_clusters == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cfg.gridDim = dim3((sms / L::CLUSTER) * L::CLUSTER);
    e = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (max_clusters <= 0) return cudaErrorInvalidConfiguration;
  }
  const int n_mt = (M_out + TM - 1) / TM, n_tiles = N * n_mt;
  const int clusters = n_tiles < max_clusters ? n_tiles : max_clusters;
  cfg.gridDim = dim3(clusters * L::CLUSTER);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, out, M, M_out, n_mt, n_tiles);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// x: (N, M, C) bf16; w: (9, C, C) bf16 as (tap, C_in, C_out); out: (N, M_out, C) bf16;
// C in {64, 128}; subtile selects off_t = t (else 0). All contiguous.
extern "C" int sdt_shift_taps_forward(const void* x, const void* w, void* out, int N, int M,
                                      int M_out, int C, int subtile, void* stream) {
  if (N <= 0 || M_out <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *xb = (const bf16*)x, *wb = (const bf16*)w;
  bf16* ob = (bf16*)out;
  if (C == 128)
    return (int)(subtile ? launch<128, true>(xb, wb, ob, N, M, M_out, st)
                         : launch<128, false>(xb, wb, ob, N, M, M_out, st));
  if (C == 64)
    return (int)(subtile ? launch<64, true>(xb, wb, ob, N, M, M_out, st)
                         : launch<64, false>(xb, wb, ob, N, M, M_out, st));
  return (int)cudaErrorInvalidValue;
}
