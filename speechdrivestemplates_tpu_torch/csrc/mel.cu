// Fused STFT + mel spectrogram for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel speechdrivestemplates_tpu/ops/mel_pallas.py
// (_mel_pallas_2d, body _make_kernel): framing of the reflect-padded audio at
// hop 160 into 512-sample frames, periodic Hann(400) window, real DFT trimmed to
// the first 256 bins, power re^2 + im^2, projection on the 80-band HTK
// filterbank. Output (B, 80, T) float32, written once; the frame matrix and the
// spectrum never leave the SM.
//
// What bounds it on an H100: arithmetic. At B=128, T=427 the DFT is
// 2 * 54656 frames * 400 taps * 512 columns = 22.4 GFLOP (+2.2 GFLOP for the
// mel projection) against 35 MB in and 17.5 MB out, i.e. ~0.016 ms of HBM
// traffic and ~0.37 ms of fp32 CUDA-core work at 67 TFLOP/s (published peaks).
//
// Design: one block of 256 threads per (sample, tile of 64 frames). The tile's
// audio span (63*160+512 floats) is staged in shared memory once; frames are
// read out of it in place, so framing costs no copies. The window is folded into
// the DFT table on the host ((400, 512) fp32, [cos | sin] over the window's
// support only, L2-resident), which also skips the 112 zero taps of the padded
// window. The DFT runs in fp32 on the CUDA cores as a register-blocked product:
// each thread holds 4 frames x 4 bins of re and im, so the power of a bin tile is
// formed in registers and goes straight into the mel accumulators (4 frames x 5
// bands per thread) through a shared-memory tile. Accumulation is fp32 in a
// fixed order. Tensor cores (3xTF32) are a later step.

#include <cuda_runtime.h>

namespace {

constexpr int HOP = 160;
constexpr int N_FFT = 512;
constexpr int WIN_OFF = 56;   // (N_FFT - 400) / 2: first sample under the window
constexpr int K_WIN = 400;    // window support = DFT taps that are not zero
constexpr int K_BINS = 256;   // bins kept; the filterbank's last non-zero bin is 239
constexpr int N_MELS = 80;
constexpr int TT = 64;        // frames per block
constexpr int BT = 64;        // bins per tile
constexpr int KC = 16;        // taps per staged chunk of the DFT table
constexpr int THREADS = 256;
constexpr int SPAN = (TT - 1) * HOP + N_FFT;       // audio samples a block reads
constexpr int PS_STRIDE = BT + 1;
constexpr int SMEM_FLOATS = SPAN + KC * 2 * BT + TT * PS_STRIDE + BT * N_MELS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;         // 87,680 bytes

static_assert(K_WIN % KC == 0, "chunking must cover the window");
static_assert((SPAN * 4) % 16 == 0, "DFT tile must stay 16-byte aligned");

__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ audio, const float* __restrict__ cs,
           const float* __restrict__ fb, float* __restrict__ out, int Lp, int T) {
  extern __shared__ __align__(16) float smem[];
  float* span = smem;                     // [SPAN]
  float* bs = span + SPAN;                // [KC][2*BT]: cos tile | sin tile
  float* ps = bs + KC * 2 * BT;           // [TT][PS_STRIDE]: power tile
  float* fbs = ps + TT * PS_STRIDE;       // [BT][N_MELS]: filterbank tile

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;

  const float* src = audio + (size_t)b * Lp + (size_t)t0 * HOP;
  const int avail = Lp - t0 * HOP;
  for (int i = tid; i < SPAN; i += THREADS) span[i] = i < avail ? src[i] : 0.f;

  // DFT layout: frames ty + 16*i, bins tx*4 + j (within the bin tile)
  const int tx = tid & 15, ty = tid >> 4;
  // mel layout: frames fg + 16*i, bands mg*5 + j
  const int fg = tid & 15, mg = tid >> 4;
  float macc[4][5];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) macc[i][j] = 0.f;

  for (int bt = 0; bt < K_BINS / BT; ++bt) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int k0 = 0; k0 < K_WIN; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < KC * 2 * BT; i += THREADS) {
        const int r = i / (2 * BT), c = i % (2 * BT);
        const int col = c < BT ? bt * BT + c : K_BINS + bt * BT + (c - BT);
        bs[i] = cs[(size_t)(k0 + r) * (2 * K_BINS) + col];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = span[(ty + 16 * i) * HOP + WIN_OFF + k0 + kk];
        const float4 c4 = *reinterpret_cast<const float4*>(&bs[kk * 2 * BT + tx * 4]);
        const float4 s4 = *reinterpret_cast<const float4*>(&bs[kk * 2 * BT + BT + tx * 4]);
        const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
        const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(a[i], cc[j], re[i][j]);
            im[i][j] = fmaf(a[i], ss[j], im[i][j]);
          }
      }
    }

    // power of this bin tile -> shared; filterbank rows of the tile -> shared
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * PS_STRIDE + tx * 4 + j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    for (int i = tid; i < BT * N_MELS; i += THREADS) fbs[i] = fb[(size_t)bt * BT * N_MELS + i];
    __syncthreads();

#pragma unroll 4
    for (int kb = 0; kb < BT; ++kb) {
      float p[4], f[5];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(fg + 16 * i) * PS_STRIDE + kb];
#pragma unroll
      for (int j = 0; j < 5; ++j) f[j] = fbs[kb * N_MELS + mg * 5 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 5; ++j) macc[i][j] = fmaf(p[i], f[j], macc[i][j]);
    }
    // the next tile's first __syncthreads() keeps ps/fbs alive until all have read
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + fg + 16 * i;
    if (t < T) {
#pragma unroll
      for (int j = 0; j < 5; ++j) out[((size_t)b * N_MELS + mg * 5 + j) * T + t] = macc[i][j];
    }
  }
}

}  // namespace

// audio_padded: (B, Lp) float32, reflect-padded by 256 on each side (Lp = L + 512)
// cs:           (400, 512) float32 windowed [cos | sin] table over the window support
// fb:           (256, 80) float32 filterbank rows of the kept bins
// out:          (B, 80, T) float32, T = L // 160 + 1
extern "C" int sdt_mel_forward(const float* audio_padded, const float* cs, const float* fb,
                               float* out, int B, int Lp, int T, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (B <= 0 || T <= 0) return 0;
  dim3 grid((T + TT - 1) / TT, B);
  mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(audio_padded, cs, fb, out, Lp, T);
  return (int)cudaGetLastError();
}
