// Fused audio-encoder stem for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel probes/stem_pallas.py (_stem_pallas, body
// _make_kernel) after its IN1: conv2 64->64 k4 s2 p1, IN2 + lrelu, conv3
// 64->128 k3 s1 p1, IN3 + lrelu. Its input is conv1's activation, already
// normalized: csrc/conv1.cu (conv1 + IN1 + lrelu, the port of
// probes/conv1_pallas.py) writes it as (B, 82, W1, 64) with zero rows 0 and 81.
// InstanceNorm statistics are fp32, variance E[x^2] - E[x]^2 (biased), eps
// 1e-5, as in the Pallas kernel.
//
// What bounds it on an H100: at B=128, W1=427 the two convolutions are
// 2 * 1.09M pixels * (64*1024 + 128*576) = 304 GFLOP, ~0.31 ms at the bf16
// dense tensor-core peak; reading its input and writing its output moves
// 0.84 GB, ~0.25 ms at 3.35 TB/s, and the bf16 intermediates y2 and y3 add
// 0.84 GB more (written and read once each). So it sits near the ridge: the
// products have to run near the tensor cores' rate while every byte moves once.
//
// Design. The TPU kernel held a whole sample's plane in VMEM; one 80x427x64
// plane is 4.4 MB in bf16 and a Hopper block has 227 KB, so blocks tile the
// planes and each InstanceNorm is a cross-block reduction:
//   1. conv_ring_kernel (bf16; conv2, then conv3): implicit GEMM over tiles of
//      128 output pixels of one row x all output channels, by persistent blocks
//      (one per SM) that walk a fixed sequence of tiles.
//      - The layer's whole bf16 weight set is loaded into shared memory once
//        per block (conv2 128 KB, conv3 144 KB) in the 128-byte-swizzled
//        K-major layout: C_in = 64 bf16 is one 128-byte row per output
//        channel, so each weight byte crosses from L2 once per block, not once
//        per tile and kernel row.
//      - A producer warpgroup keeps input row segments (the (TM-1)*S + KW
//        pixels x 64 channels one kernel row of a tile reads) in flight
//        through a ring (conv2 2 x 33 KB, conv3 4 x 16.6 KB) guarded by
//        "full" and "empty" mbarriers. conv2's segments go by cp.async, taps
//        outside the plane zero-filled (src-size 0); conv2 starts one row into
//        conv1.cu's padded plane and skips its h padding. conv3's go through
//        the producer's registers, which apply IN2 + lrelu and the bf16 cast
//        once per staged pixel and write the taps outside the plane as zeros
//        AFTER the norm (PyTorch pads the activated tensor).
//      - Two consumer warpgroups each own 64 of the tile's pixels x all output
//        channels and run wgmma.mma_async (m64n64k16 for conv2, m64n128k16 for
//        conv3, fp32 accumulators in registers). B is read by the tensor cores
//        straight from the resident weights through a shared-memory
//        descriptor; A comes from registers, where ldmatrix puts each tap's
//        fragments straight out of the staged segment (a tap's dx shift and
//        conv2's stride of 2 are row addresses; the ring is XOR-swizzled so the
//        8 rows of a phase hit distinct banks). A warpgroup loads a kernel
//        row's fragments, releases the stage and issues the row's products
//        back to back.
//      - The epilogue writes the output in bf16, neighbouring lanes trading
//        halves so that each pixel gets 32-byte pieces, and per-tile channel
//        sums of the fp32 accumulators over the valid pixels, reduced over
//        each warpgroup's warps in a fixed order.
//      Shared memory: conv2 128 KB weights + 66 KB ring + 4 KB sums; conv3
//      144 KB + 66.5 KB + 8 KB; both under 227 KB, one block per SM.
//   1'. conv_in_kernel (fp32, the tight-tolerance path): the same convolution
//      on the CUDA cores, one block per tile, fp32 intermediates.
//   2. finalize: partials summed in a fixed order (no atomics, so the result is
//      deterministic) into mean and 1/sqrt(var + eps).
//   3. apply: IN3 + lrelu + cast to the compute dtype, four channels a thread.
// The last tile of a row is ragged (W2 = 213 = 128 + 85). wgmma works on 64
// rows, so a warpgroup skips its products only when all 64 of its pixels lie
// past the row's end; at W2 = 213 none does and 17% of the products are
// padding (kept: tiles of 64 pixels, one warpgroup each, measured slower on an
// H100, and a tile spanning two rows would need two rows' segments).
// What holds it back now: conv2 stages four input rows per output row and each
// input row serves two output rows, so at B=128 it reads 1.35 GB from L2 for
// 0.56 GB of input through a ring only 2 stages deep beside the weights; and
// both warpgroups work on one tile in lockstep, so the epilogue does not
// overlap the products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H1 = 80;         // conv1 output height (mel bins)
constexpr int C1 = 64;         // conv1 / conv2 channels (= conv input channels)
constexpr int C3 = 128;        // conv3 channels
constexpr int TM = 128;        // output pixels per tile: 8 warps x 16 rows
constexpr int WARPS = 8;       // consumer warps
constexpr int CONV_THREADS = WARPS * 32;
constexpr int PRODUCER_THREADS = 128;            // one producer warpgroup
constexpr int RING_THREADS = CONV_THREADS + PRODUCER_THREADS;
constexpr float EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : slope * v; }

// Sum P partials per (sample, channel) in a fixed order; write mean and
// 1/sqrt(var + eps). One block per sample, FIN_SPLIT threads per channel, each
// summing a fixed range of the partials, then the ranges in order.
constexpr int FIN_SPLIT = 4;
__global__ void finalize_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                                float* __restrict__ mean, float* __restrict__ rstd, int P,
                                int C, float n) {
  __shared__ float rs[FIN_SPLIT][C3], rq[FIN_SPLIT][C3];
  const int b = blockIdx.x, c = threadIdx.x % C, k = threadIdx.x / C;
  const int per = (P + FIN_SPLIT - 1) / FIN_SPLIT;
  float s = 0.f, q = 0.f;
  for (int p = k * per; p < min(P, (k + 1) * per); ++p) {
    const size_t o = ((size_t)b * P + p) * C + c;
    s += psum[o];
    q += psq[o];
  }
  rs[k][c] = s;
  rq[k][c] = q;
  __syncthreads();
  if (k == 0) {
    for (int j = 1; j < FIN_SPLIT; ++j) {
      s += rs[j][c];
      q += rq[j][c];
    }
    const float m = s / n;
    mean[b * C + c] = m;
    rstd[b * C + c] = rsqrtf(q / n - m * m + EPS);
  }
}

// ---- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
__device__ __forceinline__ void warpgroup_sync(int wg) {  // the 4 warps of consumer warpgroup wg
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// writes of the generic proxy (cp.async, st.shared) visible to wgmma's reads
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
template <int NT>
__device__ __forceinline__ void fence_acc(float (*d)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// Shared-memory descriptor of a K-major bf16 operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), 1024-byte aligned.
// Advancing K by 16 elements adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// D (64 x N fp32, in registers) += A (64 x 16 bf16, in registers: per warp the
// m16n8k16 A fragment of its 16 rows) x B (16 x N, shared, descriptor); the
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
__device__ __forceinline__ void wgmma_m64n128k16(float (*d)[4], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
}

// ---- bf16: persistent blocks, resident weights, an mbarrier ring --------------

// Shared-memory plan of one layer. Rows of 64 bf16 (128 bytes) throughout, their
// 16-byte chunks XOR-swizzled: weights by output channel (the 128-byte K-major
// swizzle), staged pixels by (pixel >> SH) so that stride-S rows spread.
template <int KH, int KW, int S, int COUT, int STAGES>
struct RingPlan {
  static constexpr int AROWS = (TM - 1) * S + KW;  // pixels one kernel row of a tile reads
  static constexpr int SH = S == 2 ? 1 : 0;
  static constexpr int W_BYTES = KH * KW * COUT * 128;
  static constexpr int STAGE_BYTES = AROWS * 128;
  static constexpr int RING_OFF = W_BYTES;
  static constexpr int RED_OFF = RING_OFF + STAGES * STAGE_BYTES;  // [2][WARPS][COUT] fp32
  static constexpr int BAR_OFF = RED_OFF + 2 * WARPS * COUT * 4;   // full, empty [STAGES]
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;     // + alignment slack
  static_assert(SMEM <= 232448, "one block per SM");
  static_assert(W_BYTES % 1024 == 0 && STAGE_BYTES % 16 == 0 && RED_OFF % 16 == 0,
                "alignment of the swizzled regions");
};

__device__ __forceinline__ uint32_t swz(int row, int chunk, int key) {
  return (uint32_t)(row * 128 + ((chunk ^ (key & 7)) << 4));
}

// Producer warpgroup: the input row segments of this block's tiles, in the
// order the consumers take them, into the ring. A thread always moves the same
// 16-byte channel chunk c (8 channels) of every 16th pixel. Without NORM the
// segment is copied as it is (cp.async; taps outside the plane zero-filled);
// with NORM each value becomes bf16(lrelu((x - mean) * rstd)) on its way from
// global memory, once per staged pixel, and taps outside the plane are written
// as zeros after the norm.
template <bool NORM, int KH, int KW, int S, int P, int COUT, int STAGES>
__device__ __forceinline__ void produce(const bf16* __restrict__ x, const float* __restrict__ mean,
                                        const float* __restrict__ rstd, uint32_t sring,
                                        uint64_t* full, uint64_t* empty, int Hin, int x_rows,
                                        int Win, int Hout, int Wout, int n_tiles, float slope) {
  using L = RingPlan<KH, KW, S, COUT, STAGES>;
  constexpr int PASSES = (L::AROWS + 15) / 16;
  const int ptid = threadIdx.x - CONV_THREADS, c = ptid & 7, r0 = ptid >> 3;
  const int n_wt = (Wout + TM - 1) / TM;
  float scale[8], shift[8];  // NORM: x * scale + shift = (x - mean) * rstd
  int sb = -1;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int wt_i = t % n_wt, ho = (t / n_wt) % Hout, b = t / (n_wt * Hout);
    const int w0 = wt_i * TM, nvalid = min(TM, Wout - w0);
    const int npix = (nvalid - 1) * S + KW, wbase = w0 * S - P;
    if (NORM && b != sb) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        scale[e] = rstd[b * C1 + c * 8 + e];
        shift[e] = -mean[b * C1 + c * 8 + e] * scale[e];
      }
      sb = b;
    }
    for (int dy = 0; dy < KH; ++dy) {
      const int hi = ho * S - P + dy;
      if (hi < 0 || hi >= Hin) continue;  // a row of padding contributes nothing
      const int stage = it % STAGES;
      mbar_wait(&empty[stage], ((it / STAGES) & 1) ^ 1);
      const bf16* xrow = x + ((size_t)b * x_rows + hi) * Win * C1 + c * 8;
      const uint32_t dst = sring + stage * L::STAGE_BYTES;
      if constexpr (NORM) {
        uint4 v[PASSES];
#pragma unroll
        for (int k = 0; k < PASSES; ++k) {  // all loads first, then the arithmetic
          const int r = r0 + 16 * k, wi = wbase + r;
          v[k] = make_uint4(0u, 0u, 0u, 0u);
          if (r < npix && wi >= 0 && wi < Win)
            v[k] = __ldg(reinterpret_cast<const uint4*>(xrow + (size_t)wi * C1));
        }
#pragma unroll
        for (int k = 0; k < PASSES; ++k) {
          const int r = r0 + 16 * k, wi = wbase + r;
          if (r >= npix) break;
          uint32_t* u = reinterpret_cast<uint32_t*>(&v[k]);
          if (wi >= 0 && wi < Win) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
              const __nv_bfloat162 h =
                  __floats2bfloat162_rn(lrelu(fmaf(f.x, scale[2 * e], shift[2 * e]), slope),
                                        lrelu(fmaf(f.y, scale[2 * e + 1], shift[2 * e + 1]), slope));
              u[e] = *reinterpret_cast<const uint32_t*>(&h);
            }
          }
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + swz(r, c, r >> L::SH)),
                       "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3])
                       : "memory");
        }
        mbar_arrive(&full[stage]);  // release: the stores above are visible to the waiters
      } else {
        for (int r = r0; r < npix; r += 16) {
          const int wi = wbase + r;
          const bool ok = wi >= 0 && wi < Win;
          cp_async16_zfill(dst + swz(r, c, r >> L::SH), ok ? xrow + (size_t)wi * C1 : x, ok);
        }
        mbar_arrive_cp_async(&full[stage]);
      }
      ++it;
    }
  }
  cp_async_wait_all();
}

// y = conv(lrelu(norm(x))) (NORM) or conv(x), bf16 in and out, over tiles of TM
// output pixels of one row x all COUT channels; tile t = (b * Hout + ho) * n_wt + wt.
// x: (B, x_rows, Win, C1) bf16, its Hin rows starting at x; wt: (KH, KW, COUT, C1)
// bf16; y: (B, Hout, Wout, COUT) bf16; psum/psq: (B, Hout * n_wt * 2, COUT) fp32,
// one partial per tile and warpgroup.
template <bool NORM, int KH, int KW, int S, int P, int COUT, int STAGES>
__global__ void __launch_bounds__(RING_THREADS, 1)
conv_ring_kernel(const bf16* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const bf16* __restrict__ wt,
                 bf16* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
                 int Hin, int x_rows, int Win, int Hout, int Wout, int n_tiles, float slope) {
  using L = RingPlan<KH, KW, S, COUT, STAGES>;
  constexpr int NT = COUT / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sw = smem_u32(base);               // resident weights at sw
  const uint32_t sring = sw + L::RING_OFF;
  float* red = reinterpret_cast<float*>(base + L::RED_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_wt = (Wout + TM - 1) / TM;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCER_THREADS);  // one arrival per producer thread
      mbar_init(&empty[s], WARPS);            // one arrival per consumer warp
    }
  }
  // the layer's weights, once per block, swizzled by output channel
  for (int i = tid; i < KH * KW * COUT * 8; i += RING_THREADS) {
    const int row = i >> 3, c = i & 7;  // row = tap * COUT + n
    cp_async16_zfill(sw + swz(row, c, row), wt + (size_t)row * C1 + c * 8, true);
  }
  cp_async_wait_all();
  fence_proxy_async();  // wgmma reads the weights through the async proxy
  __syncthreads();

  if (warp >= WARPS) {
    produce<NORM, KH, KW, S, P, COUT, STAGES>(x, mean, rstd, sring, full, empty, Hin, x_rows, Win,
                                              Hout, Wout, n_tiles, slope);
    return;
  }

  // ---- consumers: two warpgroups x 64 output pixels x COUT channels ----
  const int wg = warp >> 2, g = lane >> 2, tig = lane & 3;
  // ldmatrix lane roles (A): pixel row lrow of the warp's 16, channel chunk 2 ks + asel
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, asel = lane >> 4;
  float* red_s = red;
  float* red_q = red + WARPS * COUT;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int wt_i = t % n_wt, ho = (t / n_wt) % Hout, b = t / (n_wt * Hout);
    const int w0 = wt_i * TM, nvalid = min(TM, Wout - w0);
    const bool active = wg * 64 < nvalid;  // per warpgroup: wgmma is collective
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    fence_acc<NT>(acc);

    for (int dy = 0; dy < KH; ++dy) {
      const int hi = ho * S - P + dy;
      if (hi < 0 || hi >= Hin) continue;
      const int stage = it % STAGES;
      mbar_wait(&full[stage], (it / STAGES) & 1);
      const uint32_t ring = sring + stage * L::STAGE_BYTES;
      if (active) {
        // all A fragments of this kernel row first, then the row's KW x 4
        // products back to back: no instruction defines a wgmma operand while
        // products are in flight
        uint32_t a[KW][C1 / 16][4];
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          const int q = (warp * 16 + lrow) * S + dx;  // this lane's staged pixel
#pragma unroll
          for (int ks = 0; ks < C1 / 16; ++ks)
            ldsm_x4(a[dx][ks], ring + swz(q, 2 * ks + asel, q >> L::SH));
        }
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < KW; ++dx) {
          const uint64_t wdesc = desc_sw128(sw + (dy * KW + dx) * COUT * 128);
#pragma unroll
          for (int ks = 0; ks < C1 / 16; ++ks) {
            if constexpr (COUT == 64)
              wgmma_m64n64k16(acc, a[dx][ks], wdesc + 2 * ks);
            else
              wgmma_m64n128k16(acc, a[dx][ks], wdesc + 2 * ks);
          }
        }
        wgmma_commit();
        // the stage is in registers (ldmatrix): release it before the products end
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        wgmma_wait<0>();
        fence_acc<NT>(acc);
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
      }
      ++it;
    }

    // epilogue: bf16 output and per-warpgroup channel sums of the fp32
    // accumulators over the valid pixels
    const int r0 = w0 + warp * 16 + g, r1 = r0 + 8;
    const bool o0 = r0 < Wout, o1 = r1 < Wout;
    bf16* yrow = y + ((size_t)b * Hout + ho) * Wout * COUT;
    const bool odd = tig & 1;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      // lanes tig and tig ^ 1 trade halves so that each writes 4 consecutive
      // channels (8 bytes) of one n8 tile: 32 contiguous bytes per pixel and pair
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(acc[j + 1][2 * h], acc[j + 1][2 * h + 1]);
        const uint32_t w0u = *reinterpret_cast<const uint32_t*>(&p0);
        const uint32_t w1u = *reinterpret_cast<const uint32_t*>(&p1);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0u : w1u, 1);
        const uint2 u = odd ? make_uint2(got, w1u) : make_uint2(w0u, got);
        const int r = h ? r1 : r0;
        if (h ? o1 : o0)
          *reinterpret_cast<uint2*>(&yrow[(size_t)r * COUT + (j + odd) * 8 + (tig >> 1) * 4]) = u;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + tig * 2;
      const float e0 = o0 ? acc[j][0] : 0.f, e1 = o0 ? acc[j][1] : 0.f;
      const float e2 = o1 ? acc[j][2] : 0.f, e3 = o1 ? acc[j][3] : 0.f;
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
        red_s[warp * COUT + col] = s0;
        red_s[warp * COUT + col + 1] = s1;
        red_q[warp * COUT + col] = q0;
        red_q[warp * COUT + col + 1] = q1;
      }
    }
    warpgroup_sync(wg);
    const size_t pidx = (((size_t)b * Hout + ho) * n_wt + wt_i) * 2 + wg;
    for (int c = tid & 127; c < COUT; c += 128) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int w = 4 * wg; w < 4 * wg + 4; ++w) {
        s += red_s[w * COUT + c];
        q += red_q[w * COUT + c];
      }
      psum[pidx * COUT + c] = s;
      psq[pidx * COUT + c] = q;
    }
    warpgroup_sync(wg);  // red is free for the next tile
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <bool NORM, int KH, int KW, int S, int P, int COUT, int STAGES>
cudaError_t launch_ring(const bf16* x, const float* mean, const float* rstd, const bf16* wt,
                        bf16* y, float* psum, float* psq, int B, int Hin, int x_rows, int Win,
                        int Hout, int Wout, float slope, cudaStream_t st) {
  constexpr int smem = RingPlan<KH, KW, S, COUT, STAGES>::SMEM;
  auto kernel = conv_ring_kernel<NORM, KH, KW, S, P, COUT, STAGES>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_tiles = B * Hout * ((Wout + TM - 1) / TM);
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  kernel<<<grid, RING_THREADS, smem, st>>>(x, mean, rstd, wt, y, psum, psq, Hin, x_rows, Win,
                                           Hout, Wout, n_tiles, slope);
  return cudaGetLastError();
}

// ---- fp32: the same convolution on the CUDA cores --------------------------------

constexpr int F32_STRIDE = C1 + 1;  // odd word stride: conflict-free column reads

// acc[j][0..3] += A x B over all C1 input channels for one tap, in mma.sync's
// m16n8 C fragment layout (rows g and g + 8 of the warp's 16 pixels, columns
// 2 tig and 2 tig + 1 of each n8 tile). A rows are staged input pixels (row p*S
// for output pixel p, already shifted by the tap's dx); B the tap's (COUT, C1).
template <int S, int NT>
__device__ __forceinline__ void tap_product_f32(const float* __restrict__ A,
                                                const float* __restrict__ Bt, float (*acc)[4],
                                                int warp, int g, int tig) {
  const float* a0p = A + (warp * 16 + g) * S * F32_STRIDE;
  const float* a1p = a0p + 8 * S * F32_STRIDE;
#pragma unroll 4
  for (int k = 0; k < C1; ++k) {
    const float x0 = a0p[k], x1 = a1p[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b0 = Bt[(j * 8 + tig * 2) * F32_STRIDE + k];
      const float b1 = Bt[(j * 8 + tig * 2 + 1) * F32_STRIDE + k];
      acc[j][0] = fmaf(x0, b0, acc[j][0]);
      acc[j][1] = fmaf(x0, b1, acc[j][1]);
      acc[j][2] = fmaf(x1, b0, acc[j][2]);
      acc[j][3] = fmaf(x1, b1, acc[j][3]);
    }
  }
}

template <int KW, int S, int COUT>
constexpr int conv_f32_smem_bytes() {
  return (((TM - 1) * S + KW) + KW * COUT) * F32_STRIDE * 4;
}

// y = conv(lrelu(norm(x))) (NORM) or conv(x) in fp32 for TM output pixels of row
// ho of sample b, all COUT channels. For each kernel row dy the block stages, once,
// the input row segment those pixels read (normalized and activated if NORM) and
// the KW taps' weights; every tap of that row is a product of shifted views.
// x: (B, x_rows, Win, C1); wt: (KH, KW, COUT, C1); y: (B, Hout, Wout, COUT) raw;
// psum/psq: (B, Hout * gridDim.x, COUT).
template <bool NORM, int KH, int KW, int S, int P, int COUT>
__global__ void __launch_bounds__(CONV_THREADS, 2)
conv_in_kernel(const float* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ rstd, const float* __restrict__ wt,
               float* __restrict__ y, float* __restrict__ psum, float* __restrict__ psq,
               int Hin, int x_rows, int Win, int Hout, int Wout, float slope) {
  constexpr int NT = COUT / 8;
  constexpr int AROWS = (TM - 1) * S + KW;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* As = reinterpret_cast<float*>(smem_f32);  // [AROWS][F32_STRIDE]
  float* Bs = As + AROWS * F32_STRIDE;            // [KW][COUT][F32_STRIDE]
  __shared__ float s_mean[C1], s_rstd[C1];
  __shared__ float red_s[WARPS][COUT], red_q[WARPS][COUT];

  const int w0 = blockIdx.x * TM, ho = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  if (NORM && tid < C1) {
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
    const float* xrow = x + ((size_t)b * x_rows + hi) * Win * C1;
    for (int i = tid; i < AROWS * (C1 / 4); i += CONV_THREADS) {
      const int r = i / (C1 / 4), c = (i % (C1 / 4)) * 4;
      const int wi = wbase + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};  // padding reads 0 after the norm
      if (wi >= 0 && wi < Win) {
        const float4 u = *reinterpret_cast<const float4*>(xrow + (size_t)wi * C1 + c);
        v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
        if constexpr (NORM) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = lrelu((v[e] - s_mean[c + e]) * s_rstd[c + e], slope);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) As[r * F32_STRIDE + c + e] = v[e];
    }
    const float* wsrc = wt + (size_t)dy * KW * COUT * C1;
    for (int i = tid; i < KW * COUT * (C1 / 4); i += CONV_THREADS) {
      const int row = i / (C1 / 4), c = (i % (C1 / 4)) * 4;  // row = dx * COUT + n
      const float4 u = *reinterpret_cast<const float4*>(wsrc + (size_t)row * C1 + c);
      float* d = Bs + row * F32_STRIDE + c;
      d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
    }
    __syncthreads();
#pragma unroll
    for (int dx = 0; dx < KW; ++dx)
      tap_product_f32<S, NT>(As + dx * F32_STRIDE, Bs + dx * COUT * F32_STRIDE, acc, warp, g, tig);
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
    for (int off = 4; off < 32; off <<= 1) {
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

template <bool NORM, int KH, int KW, int S, int P, int COUT>
cudaError_t launch_f32(const float* x, const float* mean, const float* rstd, const float* wt,
                       float* y, float* psum, float* psq, int B, int Hin, int x_rows, int Win,
                       int Hout, int Wout, float slope, cudaStream_t st) {
  constexpr int smem = conv_f32_smem_bytes<KW, S, COUT>();
  auto kernel = conv_in_kernel<NORM, KH, KW, S, P, COUT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Wout + TM - 1) / TM, Hout, B);
  kernel<<<grid, CONV_THREADS, smem, st>>>(x, mean, rstd, wt, y, psum, psq, Hin, x_rows, Win,
                                           Hout, Wout, slope);
  return cudaGetLastError();
}

// ---- IN3 + lrelu + cast ------------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// out = cast(lrelu((y - mean) * rstd)) over one sample's (N / C3, C3) rows per
// blockIdx.y, four channels per thread; y and out in the compute dtype T.
template <typename T>
__global__ void apply_kernel(const T* __restrict__ y, const float* __restrict__ mean,
                             const float* __restrict__ rstd, T* __restrict__ out,
                             int per_sample4, float slope) {
  __shared__ float sm[C3], sr[C3];
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C3; c += blockDim.x) {
    sm[c] = mean[b * C3 + c];
    sr[c] = rstd[b * C3 + c];
  }
  __syncthreads();
  const T* yb = y + (size_t)b * per_sample4 * 4;
  T* ob = out + (size_t)b * per_sample4 * 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_sample4; i += gridDim.x * blockDim.x) {
    float v[4];
    load4(yb + (size_t)i * 4, v);
    const int c = (i * 4) & (C3 - 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = lrelu((v[e] - sm[c + e]) * sr[c + e], slope);
    store4(ob + (size_t)i * 4, v);
  }
}

template <typename T>
cudaError_t stem_forward(const T* y1, const T* w2, const T* w3, T* out, T* y2, T* y3,
                         float* psum, float* psq, float* mean, float* rstd, int B, int W1,
                         float slope, cudaStream_t st) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int H2 = (H1 - 2) / 2 + 1, W2 = (W1 - 2) / 2 + 1;
  const int n_wt = (W2 + TM - 1) / TM;
  cudaError_t e;
#define SDT_CHECK(expr)                               \
  if ((e = (expr)) != cudaSuccess) return e

  // conv2 on conv1's activation -> y2 raw, IN2 partials. It reads the 80 data
  // rows of the padded plane (one row in); its h padding is skipped, not read.
  const T* y1_data = y1 + (size_t)W1 * C1;
  if constexpr (BF16) {
    SDT_CHECK((launch_ring<false, 4, 4, 2, 1, C1, 2>(y1_data, nullptr, nullptr, w2, y2, psum, psq,
                                                     B, H1, H1 + 2, W1, H2, W2, slope, st)));
  } else {
    SDT_CHECK((launch_f32<false, 4, 4, 2, 1, C1>(y1_data, nullptr, nullptr, w2, y2, psum, psq, B,
                                                 H1, H1 + 2, W1, H2, W2, slope, st)));
  }
  // partials per (sample, channel): one per tile and warpgroup (bf16), per tile (fp32)
  const int parts = H2 * n_wt * (BF16 ? 2 : 1);
  finalize_kernel<<<B, FIN_SPLIT * C1, 0, st>>>(psum, psq, mean, rstd, parts, C1, (float)H2 * W2);
  SDT_CHECK(cudaGetLastError());
  // conv3 on lrelu(IN2(y2)) -> y3 raw, IN3 partials
  if constexpr (BF16) {
    SDT_CHECK((launch_ring<true, 3, 3, 1, 1, C3, 4>(y2, mean, rstd, w3, y3, psum, psq, B, H2, H2,
                                                    W2, H2, W2, slope, st)));
  } else {
    SDT_CHECK((launch_f32<true, 3, 3, 1, 1, C3>(y2, mean, rstd, w3, y3, psum, psq, B, H2, H2, W2,
                                                H2, W2, slope, st)));
  }
  finalize_kernel<<<B, FIN_SPLIT * C3, 0, st>>>(psum, psq, mean, rstd, parts, C3, (float)H2 * W2);
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

// y1:  (B, 82, W1, 64) conv1's activation from conv1.cu, rows 0 and 81 zero,
//      channels last, bf16 if is_bf16 else fp32
// w2:  (4, 4, 64, 64) conv2 weight as (kh, kw, C_out, C_in), same dtype
// w3:  (3, 3, 128, 64) conv3 weight as (kh, kw, C_out, C_in), same dtype
// out: (B, 40, W2, 128) same dtype, W2 = (W1 - 2) / 2 + 1
// scratch: y2 (B, 40, W2, 64) and y3 (B, 40, W2, 128) in the same dtype;
//   fp32 psum/psq each B * 40 * ceil(W2 / 128) * 2 * 128, mean/rstd each B * 128
extern "C" int sdt_stem_forward(const void* y1, int is_bf16, const void* w2, const void* w3,
                                void* out, void* y2, void* y3, float* psum, float* psq,
                                float* mean, float* rstd, int B, int W1, float slope,
                                void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (is_bf16)
    e = stem_forward<bf16>((const bf16*)y1, (const bf16*)w2, (const bf16*)w3, (bf16*)out,
                           (bf16*)y2, (bf16*)y3, psum, psq, mean, rstd, B, W1, slope, st);
  else
    e = stem_forward<float>((const float*)y1, (const float*)w2, (const float*)w3, (float*)out,
                            (float*)y2, (float*)y3, psum, psq, mean, rstd, B, W1, slope, st);
  return (int)e;
}
