// Fused exact frequency-domain steered power (the "equiv" kernel) for Hopper.
//
// Replaces the Pallas TPU kernel
// zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py::_equiv_power_kernel.
// It computes the same function, not the same blocks.  For frame b and
// direction d, with stacked spectra S[f, :, b] = [sr | si] (K = 2M long):
//
//   Br[f,b,d] = S[f,:,b] . H1[f,:,d]      Bi[f,b,d] = S[f,:,b] . H2[f,:,d]
//   pow       = sum_f Br^2 + Bi^2                    (sqrt(cf) folded in H)
//   TH[t,b,d] = sum_f ib1[f,t] Br + ib2[f,t] Bi      (t < n_tail + Tc)
//   v[b,c,d]  = sum_j sj[b,j] Wc3[j,c,d]
//   out[b,d]  = (pow - sum_{p<n_tail} TH[p]^2
//                + sum_{c<Tc} (v_c^2 - 2 TH[n_tail+c] v_c)) * inv
//
// What bounds it on an H100: the main product has K = 2M = 512 and B*D
// outputs per bin at the reference shape (F=154, D=1824), and the padded
// H1/H2 planes are ~1.2 GB in FP32 (half that in bf16).  At the live batch
// of one frame every plane element is used once, so the kernel is bound by
// reading H from HBM (>= 0.34 ms a frame at 3.35 TB/s); at larger batches
// the FP32 FMAs on the CUDA cores take over.
//
// What the design does about it:
// * A block owns a (BT frames x 8 directions) output tile and loops over
//   all F bins itself (the TPU's sequential f grid axis), so there is no
//   cross-block reduction, no atomics, and the result is deterministic.
//   The small direction tile gives 228 blocks at the reference shape, so
//   even one frame spreads over every SM.
// * Each thread multiplies one direction over an interleaved 1/R of K for
//   all BT frames.  H goes straight into registers in batches of 8 rows
//   (16 loads in flight a thread; neighbouring lanes read neighbouring
//   directions and rows, so loads coalesce) and is reused for the BT
//   frames.  The live frame tile of 1 runs 512-thread blocks (R = 64) for
//   more loads in flight per SM; larger tiles run 256 (R = 32).
// * The R partial sums reduce through shared memory: with every thread
//   and warp shuffles where a block has fewer than 32 outputs, by the
//   output's owner thread otherwise.
// * The steered spectra never reach device memory: Parseval and the
//   tail/head inverse DFT are folded in per bin while Br/Bi are live.  The
//   ~100 tail/head accumulators per output do not fit in registers beside
//   the product tile, so they live in shared memory (Tt x BT*8 floats, up
//   to ~67 KB a block at the reference shape), opted in above 48 KB with
//   cudaFuncSetAttribute.
// * The head corrections v = sj . Wc3 are computed in the epilogue from a
//   shared-memory copy of the block's sj rows; v never reaches HBM.
// * Precision: FP32 operands (modes f32/high) or bf16 operands (mode
//   bf16), always FP32 accumulation on the CUDA cores; the tail/head term
//   is FP32 in every mode.  No wgmma and no TMA yet.
//
// Measured on an H100 80GB HBM3 at 700 W, reference shape, lerp, one
// frame: 0.65 ms in FP32 (the plain torch version 0.49 ms), 0.64 ms in
// bf16 (plain 1.39 ms).
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DT = 8;         // directions per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// threads per block: the live frame tile of 1 takes 512 (more loads in
// flight per SM at 40-odd registers); larger tiles, with 2*BT accumulators
// a thread, take 256
template <int BT>
__host__ __device__ constexpr int block_threads() {
  return BT == 1 ? 512 : 256;
}

// Dynamic shared memory of one block, in floats:
// spectra, later sj rows [BT][max(KP, JMP)] | th [Tt][NO]
// | K-group partials [2][R][NO] | warp-reduced groups [2][G2][NO] (blocks
// of fewer than 32 outputs) | Br/Bi [2][NO]
template <int BT>
size_t smem_floats(int Tt, int KP, int JMP) {
  constexpr int NT = block_threads<BT>(), NO = BT * DT, R = NT / DT;
  constexpr int G2 = NO < 32 ? NT / 32 : 0;
  return (size_t)BT * (KP > JMP ? KP : JMP) + (size_t)Tt * NO +
         2 * (size_t)R * NO + 2 * (size_t)G2 * NO + 2 * (size_t)NO;
}

template <typename T, int BT, int U>
__global__ void __launch_bounds__(block_threads<BT>())
equiv_power_kernel(const T* __restrict__ S, const T* __restrict__ H1,
                   const T* __restrict__ H2, const float* __restrict__ ib1,
                   const float* __restrict__ ib2,
                   const float* __restrict__ sj,
                   const float* __restrict__ wc3, float* __restrict__ out,
                   int F, int BP, int KP, int DP, int TtP, int n_tail,
                   int Tc, int JMP, float inv) {
  constexpr int NT = block_threads<BT>();
  constexpr int R = NT / DT;         // interleaved K groups
  constexpr int NO = BT * DT;        // outputs per block
  constexpr int G = NT / NO;         // threads sharing one output
  constexpr int LPO = NO < 32 ? 32 / NO : 1;   // of them in one warp
  constexpr int G2 = NO < 32 ? G / LPO : 0;    // groups after the warp step
  extern __shared__ float smem[];
  const int Tt = n_tail + Tc;
  float* stage = smem;                                     // [BT][KP|JMP]
  float* th = stage + (size_t)BT * (KP > JMP ? KP : JMP);  // [Tt][NO]
  float* red = th + (size_t)Tt * NO;                       // [2][R][NO]
  float* red2 = red + 2 * R * NO;                          // [2][G2][NO]
  float* brbi = red2 + 2 * G2 * NO;                        // [2][NO]

  const int tid = threadIdx.x;
  const int dx = tid % DT, r = tid / DT;     // product role
  const int o = tid % NO, g = tid / NO;      // reduction/accumulate role
  const int d0 = blockIdx.x * DT, b0 = blockIdx.y * BT;
  const int KR = KP / R;                     // a multiple of U
  const size_t plane = (size_t)KP * DP;
  const T* h1 = H1 + d0 + dx;
  const T* h2 = H2 + d0 + dx;

  for (int i = tid; i < Tt * NO; i += NT) th[i] = 0.f;
  float pw = 0.f;                            // Parseval sum, held by tid < NO

  for (int f = 0; f < F; ++f) {
    // the tile's spectra rows for this bin (contiguous: BT rows of KP)
    const T* srow = S + ((size_t)f * BP + b0) * KP;
    for (int i = tid; i < BT * KP; i += NT) stage[i] = to_f(srow[i]);
    __syncthreads();

    float ar[BT], ai[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) ar[b] = ai[b] = 0.f;
    for (int kk0 = 0; kk0 < KR; kk0 += U) {
      // a batch of U rows k = (kk0 + u) * R + r of both planes, all
      // issued before any is used
      T x1[U], x2[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t idx = f * plane + (size_t)((kk0 + u) * R + r) * DP;
        x1[u] = h1[idx];
        x2[u] = h2[idx];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = (kk0 + u) * R + r;
        const float a1 = to_f(x1[u]), a2 = to_f(x2[u]);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float sv = stage[b * KP + k];
          ar[b] = fmaf(sv, a1, ar[b]);
          ai[b] = fmaf(sv, a2, ai[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      red[r * NO + b * DT + dx] = ar[b];
      red[(R + r) * NO + b * DT + dx] = ai[b];
    }
    __syncthreads();

    // reduce the R K-group partials: where a block has few outputs (frame
    // tiles 1, 2) every thread takes part (strided sums, the lanes of a
    // warp that share an output, then G2 groups); otherwise the NO owner
    // threads sum R partials each
    if constexpr (NO < 32) {
      float br = 0.f, bi = 0.f;
#pragma unroll
      for (int q = g; q < R; q += G) {
        br += red[q * NO + o];
        bi += red[(R + q) * NO + o];
      }
#pragma unroll
      for (int off = NO; off < 32; off <<= 1) {
        br += __shfl_xor_sync(0xffffffffu, br, off);
        bi += __shfl_xor_sync(0xffffffffu, bi, off);
      }
      if (g % LPO == 0) {
        red2[(g / LPO) * NO + o] = br;
        red2[(G2 + g / LPO) * NO + o] = bi;
      }
      __syncthreads();
    }
    if (tid < NO) {
      constexpr int NQ = NO < 32 ? G2 : R;
      const float* src = NO < 32 ? red2 : red;
      float br = 0.f, bi = 0.f;
#pragma unroll 8
      for (int q = 0; q < NQ; ++q) {
        br += src[q * NO + tid];
        bi += src[(NQ + q) * NO + tid];
      }
      pw = fmaf(br, br, fmaf(bi, bi, pw));
      brbi[tid] = br;
      brbi[NO + tid] = bi;
    }
    __syncthreads();

    // tail/head inverse-DFT samples, folded in while Br/Bi are live; each
    // (t, o) accumulator has exactly one owner thread for the whole loop
    const float br = brbi[o], bi = brbi[NO + o];
    const float* i1 = ib1 + (size_t)f * TtP;
    const float* i2 = ib2 + (size_t)f * TtP;
    for (int t = g; t < Tt; t += G)
      th[t * NO + o] = fmaf(i1[t], br, fmaf(i2[t], bi, th[t * NO + o]));
    // no barrier needed here: the next bin's first barrier orders these
    // reads of brbi before its rewrite, and stage/red/red2 are rewritten
    // only after barriers every thread has passed
  }

  __syncthreads();
  if (Tc > 0) {
    const float* sjrow = sj + (size_t)b0 * JMP;
    for (int i = tid; i < BT * JMP; i += NT) stage[i] = sjrow[i];
  }
  __syncthreads();

  {
    const int b = o / DT, d = d0 + o % DT;
    float acc = 0.f;
    for (int p = g; p < n_tail; p += G) {
      const float x = th[p * NO + o];
      acc = fmaf(-x, x, acc);
    }
    const float* srow = stage + b * JMP;
    for (int c = g; c < Tc; c += G) {
      const float* w = wc3 + (size_t)c * DP + d;
      float v = 0.f;
      for (int j = 0; j < JMP; ++j)
        v = fmaf(srow[j], w[(size_t)j * Tc * DP], v);
      acc += v * v - 2.f * th[(n_tail + c) * NO + o] * v;
    }
    red[g * NO + o] = acc;
  }
  __syncthreads();
  if (tid < NO) {
    float total = pw;
    for (int q = 0; q < G; ++q) total += red[q * NO + tid];
    out[(size_t)(b0 + tid / DT) * DP + d0 + tid % DT] = total * inv;
  }
}

template <typename T, int BT>
int launch(const void* S, const void* H1, const void* H2, const float* ib1,
           const float* ib2, const float* sj, const float* wc3, float* out,
           int F, int BP, int KP, int DP, int TtP, int n_tail, int Tc,
           int JMP, float inv, cudaStream_t stream) {
  constexpr int NT = block_threads<BT>(), R = NT / DT;
  // rows in batches of 8 where K allows (K = 512 at the reference shape),
  // else of 2
  auto kern = (KP / R) % 8 == 0 ? equiv_power_kernel<T, BT, 8>
                                : equiv_power_kernel<T, BT, 2>;
  const size_t smem = sizeof(float) * smem_floats<BT>(n_tail + Tc, KP, JMP);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(DP / DT, BP / BT);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(H1),
      static_cast<const T*>(H2), ib1, ib2, sj, wc3, out, F, BP, KP, DP, TtP,
      n_tail, Tc, JMP, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int bt, const void* S, const void* H1, const void* H2,
             const float* ib1, const float* ib2, const float* sj,
             const float* wc3, float* out, int F, int BP, int KP, int DP,
             int TtP, int n_tail, int Tc, int JMP, float inv,
             cudaStream_t st) {
  switch (bt) {
    case 1: return launch<T, 1>(S, H1, H2, ib1, ib2, sj, wc3, out, F, BP,
                                KP, DP, TtP, n_tail, Tc, JMP, inv, st);
    case 2: return launch<T, 2>(S, H1, H2, ib1, ib2, sj, wc3, out, F, BP,
                                KP, DP, TtP, n_tail, Tc, JMP, inv, st);
    case 4: return launch<T, 4>(S, H1, H2, ib1, ib2, sj, wc3, out, F, BP,
                                KP, DP, TtP, n_tail, Tc, JMP, inv, st);
    case 8: return launch<T, 8>(S, H1, H2, ib1, ib2, sj, wc3, out, F, BP,
                                KP, DP, TtP, n_tail, Tc, JMP, inv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// S (F, BP, KP), H1/H2 (F, KP, DP): float32 (bf16 == 0) or bf16 (bf16 == 1).
// ib1/ib2 (F, TtP) f32; sj (BP, JMP) f32 and wc3 (JMP, Tc, DP) f32 when
// Tc > 0 (may be null otherwise); out (BP, DP) f32.  KP % 128 == 0,
// DP % 8 == 0, BP % bt == 0.  Returns a cudaError_t.
int zrt_equiv_power(const void* S, const void* H1, const void* H2,
                    const float* ib1, const float* ib2, const float* sj,
                    const float* wc3, float* out, int F, int BP, int KP,
                    int DP, int TtP, int n_tail, int Tc, int JMP, float inv,
                    int bf16, int bt, void* stream) {
  if (bt <= 0 || KP % 128 || DP % DT || BP % bt || n_tail + Tc > TtP ||
      (Tc > 0 && (sj == nullptr || wc3 == nullptr || JMP <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(bt, S, H1, H2, ib1, ib2, sj, wc3, out, F,
                                   BP, KP, DP, TtP, n_tail, Tc, JMP, inv, st);
  return dispatch<float>(bt, S, H1, H2, ib1, ib2, sj, wc3, out, F, BP, KP,
                         DP, TtP, n_tail, Tc, JMP, inv, st);
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
