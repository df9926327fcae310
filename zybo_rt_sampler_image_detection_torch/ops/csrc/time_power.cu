// Fused time-domain steered power (delay-and-sum family) for Hopper.
//
// Replaces the Pallas TPU kernels of
// zybo_rt_sampler_image_detection_tpu/ops/pallas_kernels.py:
//   _power_kernel         (K2, full delay-line scratch)
//   _power_kernel_tchunk  (K3, the tap axis in chunks)
//   _power_kernel_window  (K4, per-tile tap windows)
// with one kernel over per-(direction tile, mic) tap windows; a plan whose
// windows span all T taps (bases 0) is the dense contraction of K2/K3.  It
// computes the same function, not the same blocks.  For frame b and
// direction d, with mic m's window starting at base[tile(d), m] and TK
// taps wide:
//
//   beam[n]  = sum_{m, j<TK} w[m*TK + j, d] * s[b, m, n - tau_min - base - j]
//   out[b,d] = sum_{n<N} (beam[n] - corr[b, n, d] [n < cc])^2 * inv
//
// with s zero outside [0, N) (the C pad_delay semantics, per frame).
//
// What bounds it on an H100: the work the function needs is 2*N FLOP per
// nonzero weight and frame.  At the reference shape (Config(), lerp:
// D=1824, T=49, M=256, N=256) lerp has 2 nonzero taps of 49 per
// (direction, mic): about 0.48 GFLOP a frame, >= 7 us at the 67 TFLOP/s of
// FP32 on the CUDA cores, against about 4 MB of signal and nonzero weights
// (1.2 us at 3.35 TB/s): bound by operations.  The kernel multiplies dense
// windows: at tile 32 Tw = 9, 2.15 GFLOP a frame, 4.5x the needed work
// (all 49 taps would be 24x).
//
// What the design does about it:
// * Windows: each (direction tile, mic) runs over the Tw taps that hold
//   its nonzero weights, not all T.  The staged slab row of mic m starts
//   at its window's first shift, so the base is one int per staged row.
// * Implicit GEMM: Sdel[(m, j), n] = s[m, n - tau] is Toeplitz in (j, n).
//   A block stages, per group of MG mics, a slab of the frame's samples
//   (32*NI + TK - 1 of them, zero-filled) in shared memory and reads every
//   shifted operand from it.  Neither the delay lines nor the (B, D, N)
//   beams reach device memory (the TPU kernel's property).
// * One frame does not fit a block (256 KB in FP32 at the reference shape,
//   more than 227 KB), so the K loop runs over (mic group, tap chunk)
//   pairs and stages MG x (N + TK) slabs, not the frame.
// * A block owns whole outputs: one frame x tile_d directions, all N
//   samples (in passes of 32*NI) and all of K.  Beams are complete before
//   they are squared (what K3's acc_ref was for); no cross-block sums, no
//   atomics, deterministic results.
// * Warp w owns 8 directions; lane l owns samples n = l + 32*i.  Per k step
//   a lane reads NI slab values (consecutive lanes, consecutive addresses:
//   no bank conflicts) and 8 weights (two broadcast float4 loads) and does
//   8*NI FMAs from registers.
// * Epilogue: subtract the corrections on the first cc samples, square,
//   sum over n (lanes, then warp shuffles) and scale by 1/(M^2 N).
// * Precision: FP32 operands (modes f32/high) or bf16 operands (mode bf16,
//   widened to FP32 in shared memory, which is exact), FP32 sums.  Plain
//   FMAs on the CUDA cores: no wgmma and no TMA yet.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DW = 8;             // directions per warp
constexpr int MAX_THREADS = 128;  // tile_d 32 = 4 warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dynamic shared memory of one block, in floats: slab [MG][LP] (rounded to
// a float4) | weight tile [MG*TKC][TD]
size_t smem_floats(int NI, int TK, int TD, int MG, int TKC) {
  const size_t LP = 32 * NI + TK - 1;
  return ((size_t)MG * LP + 3) / 4 * 4 + (size_t)MG * TKC * TD;
}

template <typename T, int NI>
__global__ void __launch_bounds__(MAX_THREADS)
time_power_kernel(const T* __restrict__ s, const T* __restrict__ w,
                  const int* __restrict__ bases,
                  const float* __restrict__ corr, float* __restrict__ out,
                  int M, int N, int TK, int DP, int TD, int tau_min, int cc,
                  int MG, int TKC, float inv) {
  constexpr int NP = 32 * NI;       // samples per pass
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LP = NP + TK - 1;
  float* slab = smem;                                           // [MG][LP]
  float* ws = smem + ((size_t)MG * LP + 3) / 4 * 4;             // [MG*TKC][TD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int b = blockIdx.x, tile = blockIdx.y;
  const int d0 = tile * TD, dw = d0 + warp * DW;
  const int* tb = bases + (size_t)tile * M;

  float psum[DW];
#pragma unroll
  for (int dd = 0; dd < DW; ++dd) psum[dd] = 0.f;

  for (int n0 = 0; n0 < N; n0 += NP) {
    float acc[NI][DW];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int dd = 0; dd < DW; ++dd) acc[i][dd] = 0.f;

    for (int m0 = 0; m0 < M; m0 += MG) {
      const int mg = min(MG, M - m0);
      __syncthreads();      // the previous group's reads are done
      // slab row mm: q -> s[b, m0+mm, n0 + q - (tau + TK - 1)] with tau
      // the window's first shift, zero outside the frame
      for (int mm = warp; mm < mg; mm += nwarps) {
        const int m = m0 + mm;
        const int off = n0 - (tau_min + tb[m] + TK - 1);
        const T* src = s + ((size_t)b * M + m) * N;
        float* dst = slab + (size_t)mm * LP;
        for (int q = lane; q < LP; q += 32) {
          const int p = q + off;
          dst[q] = (p >= 0 && p < N) ? to_f(src[p]) : 0.f;
        }
      }
      for (int j0 = 0; j0 < TK; j0 += TKC) {
        const int tk = min(TKC, TK - j0);
        if (j0 > 0) __syncthreads();    // the previous tap chunk is done
        // weight tile row (mm, jj) <- w[(m0+mm)*TK + j0 + jj][d0, d0 + TD)
        for (int r = warp; r < mg * tk; r += nwarps) {
          const int mm = r / tk, jj = r - mm * tk;
          const T* src = w + ((size_t)(m0 + mm) * TK + j0 + jj) * DP + d0;
          float* dst = ws + ((size_t)mm * TKC + jj) * TD;
          for (int dd = lane; dd < TD; dd += 32) dst[dd] = to_f(src[dd]);
        }
        __syncthreads();
        for (int mm = 0; mm < mg; ++mm) {
          // slab index of sample n = n0 + lane + 32 i at tap j = j0 + jj:
          // lane + 32 i + TK - 1 - j
          const float* xrow = slab + (size_t)mm * LP + lane + TK - 1 - j0;
          const float4* wrow = reinterpret_cast<const float4*>(
              ws + (size_t)mm * TKC * TD + warp * DW);
          const int wstride = TD / 4;
#pragma unroll 2
          for (int jj = 0; jj < tk; ++jj) {
            const float4 wa = wrow[jj * wstride], wb = wrow[jj * wstride + 1];
            const float wv[DW] = {wa.x, wa.y, wa.z, wa.w,
                                  wb.x, wb.y, wb.z, wb.w};
            const float* xr = xrow - jj;
#pragma unroll
            for (int i = 0; i < NI; ++i) {
              const float xv = xr[32 * i];
#pragma unroll
              for (int dd = 0; dd < DW; ++dd)
                acc[i][dd] = fmaf(xv, wv[dd], acc[i][dd]);
            }
          }
        }
      }
    }

    // this pass's samples: subtract the corrections, square, sum
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int n = n0 + lane + 32 * i;
      if (n < N) {
        float v[DW];
#pragma unroll
        for (int dd = 0; dd < DW; ++dd) v[dd] = acc[i][dd];
        if (corr != nullptr && n < cc) {
          const float4* c = reinterpret_cast<const float4*>(
              corr + ((size_t)b * cc + n) * DP + dw);
          const float4 ca = c[0], cb = c[1];
          v[0] -= ca.x; v[1] -= ca.y; v[2] -= ca.z; v[3] -= ca.w;
          v[4] -= cb.x; v[5] -= cb.y; v[6] -= cb.z; v[7] -= cb.w;
        }
#pragma unroll
        for (int dd = 0; dd < DW; ++dd)
          psum[dd] = fmaf(v[dd], v[dd], psum[dd]);
      }
    }
  }

  // the warp holds all samples of its 8 directions: reduce over lanes
#pragma unroll
  for (int dd = 0; dd < DW; ++dd)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum[dd] += __shfl_xor_sync(0xffffffffu, psum[dd], o);
  if (lane == 0) {
#pragma unroll
    for (int dd = 0; dd < DW; ++dd)
      out[(size_t)b * DP + dw + dd] = psum[dd] * inv;
  }
}

template <typename T, int NI>
int launch(const void* s, const void* w, const int* bases, const float* corr,
           float* out, int BP, int M, int N, int TK, int DP, int TD,
           int tau_min, int cc, int MG, int TKC, float inv,
           cudaStream_t stream) {
  auto kern = time_power_kernel<T, NI>;
  const size_t smem = sizeof(float) * smem_floats(NI, TK, TD, MG, TKC);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BP, DP / TD);
  kern<<<grid, TD * 4, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(w), bases, corr, out,
      M, N, TK, DP, TD, tau_min, cc, MG, TKC, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int NI, const void* s, const void* w, const int* bases,
             const float* corr, float* out, int BP, int M, int N, int TK,
             int DP, int TD, int tau_min, int cc, int MG, int TKC, float inv,
             cudaStream_t st) {
  switch (NI) {
    case 2: return launch<T, 2>(s, w, bases, corr, out, BP, M, N, TK, DP, TD,
                                tau_min, cc, MG, TKC, inv, st);
    case 4: return launch<T, 4>(s, w, bases, corr, out, BP, M, N, TK, DP, TD,
                                tau_min, cc, MG, TKC, inv, st);
    case 8: return launch<T, 8>(s, w, bases, corr, out, BP, M, N, TK, DP, TD,
                                tau_min, cc, MG, TKC, inv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// s (BP, M, N) and w (M*TK, DP): float32 (bf16 == 0) or bf16 (bf16 == 1);
// bases (DP / tile_d, M) int32: mic m's window in direction tile i starts
// at tap bases[i * M + m]; corr (BP, cc, DP) f32, or null with cc == 0;
// out (BP, DP) f32.  tile_d in {8, 16, 32} divides DP; NI in {2, 4, 8}.
// Returns a cudaError_t.
int zrt_time_power(const void* s, const void* w, const int* bases,
                   const float* corr, float* out, int BP, int M, int N,
                   int TK, int DP, int tile_d, int tau_min, int cc, int MG,
                   int TKC, int NI, float inv, int bf16, void* stream) {
  if (!(tile_d == 8 || tile_d == 16 || tile_d == 32) || DP % tile_d ||
      bases == nullptr || BP <= 0 || M <= 0 || N <= 0 || TK <= 0 ||
      MG <= 0 || TKC <= 0 || cc < 0 || cc > N ||
      (cc > 0 && corr == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(NI, s, w, bases, corr, out, BP, M, N, TK,
                                   DP, tile_d, tau_min, cc, MG, TKC, inv, st);
  return dispatch<float>(NI, s, w, bases, corr, out, BP, M, N, TK, DP,
                         tile_d, tau_min, cc, MG, TKC, inv, st);
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
