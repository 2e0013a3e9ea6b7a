// Fused STFT + mel spectrogram for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel speechdrivestemplates_tpu/ops/mel_pallas.py
// (_mel_pallas_2d, body _make_kernel): framing of the reflect-padded audio at
// hop 160 into 512-sample frames, periodic Hann(400) window, real DFT trimmed to
// the first 256 bins, power re^2 + im^2, projection on the 80-band HTK
// filterbank. Output (B, 80, T) float32, written once; the frame matrix and the
// spectrum never leave the SM.
//
// What bounds it on an H100: tensor-core arithmetic. At B=128, T=427 the DFT is
// 2 * 54656 frames * 400 taps * 512 columns = 22.4 GFLOP and the mel projection
// 2.2 GFLOP; run as three bf16 passes that is 73.9 GFLOP, 0.075 ms at the
// 989 TFLOP/s bf16 dense peak, against 52.4 MB of HBM traffic (0.016 ms at
// 3.35 TB/s). The same work in fp32 on the CUDA cores is capped at 67 TFLOP/s.
//
// Design. Both products run on the tensor cores (mma.sync m16n8k16, fp32
// accumulation) through the split the TPU kernel used: each fp32 operand x is
// hi = bf16(x), lo = bf16(x - hi), and a product is hi*hi + hi*lo + lo*hi,
// about 2^-16 relative. The window is folded into the DFT table on the host,
// which also skips the 112 zero taps of the padded window; the table's and the
// filterbank's hi/lo halves are constants split on the host.
//   - A block owns a tile of up to 128 frames of the flattened (b, t) axis, so
//     the whole grid reads the (400, 512) table halves (0.82 MB) from L2 once
//     per 128 frames: 427 times at B=128, T=427, 350 MB, where one block per
//     64 frames of a sample read them 896 times, 0.73 GB. A tile may cross
//     sample boundaries: each sample's part (a segment) gets its own rows.
//   - The block stages its audio once, split into hi/lo bf16, reading the
//     unpadded (B, L) input and mirroring indices at both ends (reflect
//     padding in the kernel). A segment is stored as hop rows of 160 samples
//     at a stride of 168: frame t's taps are rows t.., and a 16-byte ldmatrix
//     row (8 taps) never crosses a row. The 8-element skew makes the eight
//     frames of one ldmatrix phase fall in distinct banks (21 x 16 B per row).
//   - The table streams through two buffers of 80 taps x 128 columns (64 cos |
//     64 sin bins of one bin chunk) with cp.async, one chunk ahead. A warp
//     owns 16 frames x 128 columns, so the cos and sin accumulators of a bin
//     sit in the same thread: power is formed in registers, re-split, and fed
//     as the A operand of the mel product (the accumulator layout of two n8
//     tiles is the A layout of one k16 step) against the staged filterbank
//     rows of the chunk.
//   - The mel tile goes out through shared memory so that a warp writes
//     consecutive frames of one band.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;
constexpr int K_WIN = 400;    // window support = DFT taps that are not zero
constexpr int PAD_OFF = 200;  // tap 0 of frame t reads sample t*HOP - 200 (256 pad - 56)
constexpr int K_BINS = 256;   // bins kept; the filterbank's last non-zero bin is 239
constexpr int N_MELS = 80;
constexpr int TM = 128;       // frames per tile at most: 8 warps x 16
constexpr int THREADS = 256;
constexpr int BC = 64;        // bins per chunk: 64 cos + 64 sin columns
constexpr int NCOL = 2 * BC;
constexpr int KC = 80;        // taps per staged table chunk
constexpr int N_KC = K_WIN / KC;
constexpr int N_CHUNKS = (K_BINS / BC) * N_KC;
constexpr int ROWS_MAX = 136;     // staged hop rows: frames + 2 per segment
constexpr int SSTR = HOP + 8;     // span row stride (elements)
constexpr int TSTR = NCOL + 8;    // table chunk row stride
constexpr int FSTR = N_MELS + 8;  // filterbank row stride
constexpr int OSTR = TM + 4;      // output tile row stride (floats)

constexpr int SPAN_ELEMS = ROWS_MAX * SSTR;
constexpr int TAB_ELEMS = KC * TSTR;
constexpr int FB_ELEMS = BC * FSTR;
// span hi, lo | table [2 stages][hi, lo] | filterbank [2 buffers][hi, lo]
constexpr int SMEM_BYTES = (2 * SPAN_ELEMS + 4 * TAB_ELEMS + 4 * FB_ELEMS) * 2;  // 223,488

static_assert(K_WIN % KC == 0 && KC % 16 == 0, "chunks of whole k16 steps");
static_assert(HOP % 8 == 0 && PAD_OFF % 8 == 0, "8-tap groups stay inside a hop row");
static_assert(N_MELS * OSTR * 4 <= 4 * TAB_ELEMS * 2, "output tile fits the table buffers");
static_assert(SMEM_BYTES <= 232448, "one block per SM");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// hi*hi + hi*lo + lo*hi into one fp32 accumulator
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah, const uint32_t* al,
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_bf16_16816(d, ah, bh0, bh1);
  mma_bf16_16816(d, ah, bl0, bl1);
  mma_bf16_16816(d, al, bh0, bh1);
}

__device__ __forceinline__ void split(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}
// two fp32 values -> packed bf16x2 hi and lo (first value in the low half)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// audio: (B, L) fp32 unpadded; cs_hi/lo: (400, 512) bf16; fb_hi/lo: (256, 80) bf16;
// out: (B, 80, T) fp32. Block x owns flattened frames [x*F, x*F + F).
__global__ void __launch_bounds__(THREADS, 1)
mel_kernel(const float* __restrict__ audio, const bf16* __restrict__ cs_hi,
           const bf16* __restrict__ cs_lo, const bf16* __restrict__ fb_hi,
           const bf16* __restrict__ fb_lo, float* __restrict__ out, int L, int T, int total,
           int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* span_hi = reinterpret_cast<bf16*>(smem_raw);
  bf16* span_lo = span_hi + SPAN_ELEMS;
  bf16* tab = span_lo + SPAN_ELEMS;   // [stage][hi, lo][KC][TSTR]
  bf16* fbs = tab + 4 * TAB_ELEMS;    // [buffer][hi, lo][BC][FSTR]
  float* otile = reinterpret_cast<float*>(tab);  // [N_MELS][OSTR], after the last chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int f0 = blockIdx.x * F;
  const int nf = min(F, total - f0);  // frames of this tile
  const int b0 = f0 / T, t0 = f0 % T;
  const int n0 = min(T - t0, nf);     // frames of the first segment

  // chunk c: bin chunk c / N_KC, taps (c % N_KC) * KC ..; the filterbank rows
  // of a bin chunk come with its first tap chunk
  auto issue = [&](int c) {
    const int bt = c / N_KC, k0 = (c % N_KC) * KC;
    bf16* dst = tab + (c & 1) * 2 * TAB_ELEMS;
    for (int i = tid; i < 2 * KC * (NCOL / 8); i += THREADS) {
      const int half = i / (KC * (NCOL / 8)), j = i % (KC * (NCOL / 8));
      const int r = j / (NCOL / 8), q = (j % (NCOL / 8)) * 8;  // q: column in the chunk
      const int col = q < BC ? bt * BC + q : K_BINS + bt * BC + (q - BC);
      cp_async16(dst + half * TAB_ELEMS + r * TSTR + q,
                 (half ? cs_lo : cs_hi) + (size_t)(k0 + r) * (2 * K_BINS) + col);
    }
    if (c % N_KC == 0) {
      bf16* fdst = fbs + (bt & 1) * 2 * FB_ELEMS;
      for (int i = tid; i < 2 * BC * (N_MELS / 8); i += THREADS) {
        const int half = i / (BC * (N_MELS / 8)), j = i % (BC * (N_MELS / 8));
        const int r = j / (N_MELS / 8), q = (j % (N_MELS / 8)) * 8;
        cp_async16(fdst + half * FB_ELEMS + r * FSTR + q,
                   (half ? fb_lo : fb_hi) + (size_t)(bt * BC + r) * N_MELS + q);
      }
    }
    cp_async_commit();
  };
  issue(0);

  // stage the audio of each segment as hi/lo hop rows, mirrored at both ends
  {
    int row0 = 0, f = f0;
    for (int b = b0; f < f0 + nf; ++b) {
      const int ta = b == b0 ? t0 : 0;
      const int n = min(T - ta, f0 + nf - f);
      const int s0 = ta * HOP - PAD_OFF;
      const float* src = audio + (size_t)b * L;
      for (int i = tid; i < (n + 2) * HOP; i += THREADS) {
        int idx = s0 + i;
        idx = idx < 0 ? -idx : idx;
        idx = idx >= L ? 2 * (L - 1) - idx : idx;
        bf16 hi, lo;
        split(src[idx], hi, lo);
        const int o = (row0 + i / HOP) * SSTR + i % HOP;
        span_hi[o] = hi;
        span_lo[o] = lo;
      }
      row0 += n + 2;
      f += n;
    }
  }

  // this lane's ldmatrix row: frame r of the tile; its first hop row in the span
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lsel = (lane >> 4) * 8;
  int arow = 0;
  {
    const int r = warp * 16 + lrow;
    if (r < nf) {
      const int f = f0 + r, seg = f / T - b0, t = f % T;
      arow = seg == 0 ? t - t0 : (n0 + 2) + (seg - 1) * (T + 2) + t;
    }
  }
  const bool active = warp * 16 < nf;

  float acc[2 * BC / 8][4];   // n8 tiles: cos bins 0..63 of the chunk, then sin
  float macc[N_MELS / 8][4];  // mel bands
#pragma unroll
  for (int j = 0; j < 2 * BC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < N_MELS / 8; ++j) macc[j][0] = macc[j][1] = macc[j][2] = macc[j][3] = 0.f;

  for (int c = 0; c < N_CHUNKS; ++c) {
    if (c + 1 < N_CHUNKS) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, at c = 0, the span) visible to all
    const int bt = c / N_KC, k0 = (c % N_KC) * KC;
    if (active) {
      const bf16* th = tab + (c & 1) * 2 * TAB_ELEMS + lrow * TSTR + lsel;
      const bf16* tl = th + TAB_ELEMS;
#pragma unroll
      for (int s = 0; s < KC / 16; ++s) {
        const int k = k0 + s * 16 + lsel;  // this lane's 8 taps
        const int o = (arow + k / HOP) * SSTR + k % HOP;
        uint32_t ah[4], al[4];
        ldsm_x4(ah, span_hi + o);
        ldsm_x4(al, span_lo + o);
#pragma unroll
        for (int j = 0; j < 2 * BC / 8; j += 2) {
          uint32_t bh[4], bl[4];
          ldsm_x4_trans(bh, th + s * 16 * TSTR + j * 8);
          ldsm_x4_trans(bl, tl + s * 16 * TSTR + j * 8);
          mma3(acc[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(acc[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
      if (c % N_KC == N_KC - 1) {
        // power of the chunk's 64 bins -> A operand of the mel product
        const bf16* fh = fbs + (bt & 1) * 2 * FB_ELEMS + lrow * FSTR + lsel;
        const bf16* fl = fh + FB_ELEMS;
#pragma unroll
        for (int i = 0; i < BC / 16; ++i) {
          float p[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float re = acc[2 * i + h][e], im = acc[BC / 8 + 2 * i + h][e];
              p[h][e] = re * re + im * im;
            }
          uint32_t ah[4], al[4];
          split2(p[0][0], p[0][1], ah[0], al[0]);
          split2(p[0][2], p[0][3], ah[1], al[1]);
          split2(p[1][0], p[1][1], ah[2], al[2]);
          split2(p[1][2], p[1][3], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < N_MELS / 8; n += 2) {
            uint32_t bh[4], bl[4];
            ldsm_x4_trans(bh, fh + i * 16 * FSTR + n * 8);
            ldsm_x4_trans(bl, fl + i * 16 * FSTR + n * 8);
            mma3(macc[n], ah, al, bh[0], bh[1], bl[0], bl[1]);
            mma3(macc[n + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2 * BC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
    }
    __syncthreads();  // buffer c & 1 is free for chunk c + 2
  }

  // mel tile -> shared (band-major) -> out, consecutive frames of one band per warp
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < N_MELS / 8; ++n) {
    const int m = n * 8 + tig * 2;
    otile[m * OSTR + r0] = macc[n][0];
    otile[(m + 1) * OSTR + r0] = macc[n][1];
    otile[m * OSTR + r0 + 8] = macc[n][2];
    otile[(m + 1) * OSTR + r0 + 8] = macc[n][3];
  }
  __syncthreads();
  for (int i = tid; i < N_MELS * nf; i += THREADS) {
    const int m = i / nf, r = i % nf;
    const int f = f0 + r, b = f / T, t = f % T;
    out[((size_t)b * N_MELS + m) * T + t] = otile[m * OSTR + r];
  }
}

}  // namespace

// audio: (B, L) float32, unpadded, L > 256 (reflect padding needs it)
// cs_hi, cs_lo: (400, 512) bf16 halves of the windowed [cos | sin] table over the window
// fb_hi, fb_lo: (256, 80) bf16 halves of the filterbank rows of the kept bins
// out:          (B, 80, T) float32, T = L // 160 + 1
extern "C" int sdt_mel_forward(const float* audio, const void* cs_hi, const void* cs_lo,
                               const void* fb_hi, const void* fb_lo, float* out, int B, int L,
                               int T, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // out was allocated for T frames: refuse any other framing than the kernel's
  if (L <= 256 || T != L / HOP + 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long total = (long long)B * T;
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // the most frames a tile can take with its segments' rows (2 extra per
  // segment) inside ROWS_MAX
  int F = TM;
  while (F > 16 && F + 2 * ((F - 1 + T - 1) / T + 1) > ROWS_MAX) F -= 16;
  const int grid = (int)((total + F - 1) / F);
  mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      audio, (const bf16*)cs_hi, (const bf16*)cs_lo, (const bf16*)fb_hi, (const bf16*)fb_lo, out,
      L, T, (int)total, F);
  return (int)cudaGetLastError();
}
