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
// Design: implicit GEMM on mma.sync m16n8k16 (bf16 in, fp32 accumulators). One block of 8
// warps per (plane n, TM = 128 output rows) and all C output columns; a warp owns 16 rows x C
// columns. The block stages its window of x once with cp.async: TM rows (aligned) or TM + 8
// rows (subtile). A shift of one row is C * 2 bytes, so all nine views stay 16-byte aligned
// and ldmatrix reads them in place. The nine (C, C) weight tiles take 288 KB at C = 128,
// more than a block's 227 KB, so they stream through two buffers: tap t + 1's tile is in
// flight while tap t's products run. Shared rows are padded by 8 elements so ldmatrix's
// eight row addresses fall in distinct banks. No wgmma or TMA yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 9;
constexpr int TM = 128;  // output rows per block: 8 warps x 16
constexpr int THREADS = 256;

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

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
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

template <int C, bool SHIFT>
struct Tile {
  static constexpr int STR = C + 8;                        // padded shared row, elements
  static constexpr int AROWS = TM + (SHIFT ? TAPS - 1 : 0);  // staged rows of x
  static constexpr int A_ELEMS = AROWS * STR;
  static constexpr int B_ELEMS = C * STR;                  // one tap's (C_in, C_out) tile
  static constexpr int SMEM = (A_ELEMS + 2 * B_ELEMS) * (int)sizeof(bf16);
};

// x: (N, M, C) bf16; w: (9, C_in, C_out) bf16; out: (N, M_out, C) bf16. grid (ceil(M_out/TM), N)
template <int C, bool SHIFT>
__global__ void __launch_bounds__(THREADS, 2)
shift_taps_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out,
                  int M, int M_out) {
  using L = Tile<C, SHIFT>;
  constexpr int STR = L::STR, NT = C / 8, CH = C / 8;  // n8 tiles; 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [AROWS][STR]
  bf16* Bs = As + L::A_ELEMS;                    // [2][C][STR], rows k, columns n

  const int m0 = blockIdx.x * TM, n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  // the window of x, rows beyond M read as zero (they feed only masked outputs)
  const bf16* xn = x + (size_t)n * M * C;
  for (int i = tid; i < L::AROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* dst = As + r * STR + c;
    if (m0 + r < M)
      cp_async16(dst, xn + (size_t)(m0 + r) * C + c);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  auto stage_w = [&](int t) {
    bf16* dst = Bs + (t & 1) * L::B_ELEMS;
    const bf16* src = w + (size_t)t * C * C;
    for (int i = tid; i < C * CH; i += THREADS) {
      const int k = i / CH, c = (i % CH) * 8;
      cp_async16(dst + k * STR + c, src + (size_t)k * C + c);
    }
  };
  stage_w(0);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix lane roles: matrix i = lane / 8 takes row (lane % 8) + 8 * (i % 2), column
  // offset 8 * (i / 2): A fragments a0..a3 and, transposed, B fragments of two n8 tiles
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  for (int t = 0; t < TAPS; ++t) {
    if (t + 1 < TAPS) {
      stage_w(t + 1);
      cp_async_commit();
      cp_async_wait<1>();  // everything but tap t + 1's tile has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* A = As + ((SHIFT ? t : 0) + warp * 16 + lrow) * STR + lcol;
    const bf16* Bt = Bs + (t & 1) * L::B_ELEMS + lrow * STR + lcol;
#pragma unroll
    for (int ks = 0; ks < C; ks += 16) {
      uint32_t a[4];
      ldsm_x4(a, A + ks);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, Bt + ks * STR + j * 8);
        mma_bf16_16816(acc[j], a, b[0], b[1]);
        mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // tap t's buffer is free for tap t + 2
  }

  // epilogue: rows g and g + 8 of the warp's 16, columns 2 * tig + {0, 1} of each n8 tile
  const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
  bf16* on = out + (size_t)n * M_out * C;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + tig * 2;
    if (r0 < M_out)
      *reinterpret_cast<__nv_bfloat162*>(on + (size_t)r0 * C + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r1 < M_out)
      *reinterpret_cast<__nv_bfloat162*>(on + (size_t)r1 * C + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int C, bool SHIFT>
cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int N, int M, int M_out,
                   cudaStream_t st) {
  constexpr int smem = Tile<C, SHIFT>::SMEM;
  auto kernel = shift_taps_kernel<C, SHIFT>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  kernel<<<dim3((M_out + TM - 1) / TM, N), THREADS, smem, st>>>(x, w, out, M, M_out);
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
