// Fused exact frequency-domain steered power in the direction-innermost
// order (the "fd" sweep) for Hopper.
//
// Replaces the Pallas TPU kernel
// zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py::_equiv_power_kernel_fd.
// It computes the function of equiv_power.cu (K1): for frame b and
// direction d, with stacked spectra S[f, b, :] = [sr | si] (K = 2M long),
//
//   Br[f,b,d] = S[f,b,:] . H1[f,:,d]      Bi[f,b,d] = S[f,b,:] . H2[f,:,d]
//   TH[t,b,d] = sum_f ib1[f,t] Br + ib2[f,t] Bi        (t < n_tail + Tc)
//   v[c,b,d]  = sum_j sj[b,j] Wc3[j,c,d]
//   out[b,d]  = (sum_f Br^2 + Bi^2 - sum_{p<n_tail} TH[p]^2
//                + sum_{c<Tc} (v_c^2 - 2 TH[n_tail+c] v_c)) * inv
//
// in the TPU kernel's order: the FP bins are cut into n_fc chunks of fc,
// and a block sweeps the direction axis innermost.
//
// What bounds it on an H100: the same work as K1, so the same bound.  At
// one frame every element of the H1/H2 planes (1.15 GB in FP32 at the
// reference shape) is read once: HBM bytes, >= 0.34 ms.  At larger
// batches the FP32 FMAs on the CUDA cores.  What the order changes is the
// traffic in S: K1 restages its frames' spectra once per 8-direction tile
// (228 times at the reference shape); here a block stages its S chunk once
// and reuses it for every tile of its direction group.
//
// What the design does about it:
// * Grid (BP/BT frame tiles, n_dg direction groups, n_fc chunks), frame
//   tiles fastest, so the blocks that read the same H rows run together
//   and share them through L2.  The host picks n_dg so that the grid fills
//   every SM even at one frame (one frame and n_fc chunks alone would
//   leave most SMs idle) without a short last wave, from the blocks an SM
//   holds as the runtime reports them (zrt_equiv_power_fd_blocks_per_sm:
//   registers count as well as shared memory and threads).
// * A block copies its S chunk (fc bins x BT frames x KP, in the plane
//   type, 16 bytes a thread) into shared memory once, then sweeps the
//   direction tiles grp, grp + n_dg, ...  Per tile and bin it runs K1's
//   product and reduction (one direction over an interleaved 1/R of K per
//   thread, H straight to registers in batches of U rows), and folds the
//   Parseval sum and the tail/head samples in while Br/Bi are live.
// * At the end of a tile each (chunk, b, d) writes its partial Parseval sum
//   to pow_part (n_fc, BP, DP) and its Tt partial tail/head samples to
//   th_part (n_fc, Tt, BP, DP): the port's form of the TPU's aliased
//   pow0/th0 windows, which the TPU kernel round-trips through HBM between
//   f-chunks.  No aliasing is needed: nothing reads a partial before the
//   second kernel.
// * A second, small kernel on the same stream sums the partials in chunk
//   order, subtracts the tails and adds the head corrections v = sj . Wc3,
//   a block per (frame tile, direction tile) as in K1's epilogue, each
//   Wc3 element loaded once per frame tile for all its frames, the loads
//   spread over all the block's threads.  No atomics: the result is
//   deterministic.
// * Shared memory is the S chunk plus K1's working set (the Tt x BT*8
//   tail/head accumulators, the K-group partials, Br/Bi), up to the 227 KB
//   a block can opt into with cudaFuncSetAttribute; the host plans fc so
//   that it fits (ops/equiv_kernel.py, smem_bytes_fd / fd_chunks).
// * Precision: FP32 operands (modes f32/high) or bf16 operands staged as
//   bf16 (mode bf16, twice the bins a chunk), always FP32 accumulation on
//   the CUDA cores; the tail/head term and the finish are FP32 in every
//   mode.  No wgmma and no TMA yet.
//
// Plain C interface, loaded with ctypes; both launches go on the caller's
// stream and the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DT = 8;          // directions per tile
constexpr int FIN_THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// threads per block, as in K1: 512 at the live frame tile of 1 (more loads
// in flight per SM), 256 for larger tiles (2*BT accumulators a thread)
template <int BT>
__host__ __device__ constexpr int block_threads() {
  return BT == 1 ? 512 : 256;
}

// The working set after the staged S chunk, in floats:
// th [Tt][NO] | K-group partials [2][R][NO] | warp-reduced groups
// [2][G2][NO] (blocks of fewer than 32 outputs) | Br/Bi [2][NO]
template <int BT>
size_t work_floats(int Tt) {
  constexpr int NT = block_threads<BT>(), NO = BT * DT, R = NT / DT;
  constexpr int G2 = NO < 32 ? NT / 32 : 0;
  return (size_t)Tt * NO + 2 * (size_t)R * NO + 2 * (size_t)G2 * NO +
         2 * (size_t)NO;
}

template <typename T, int BT, int U>
__global__ void __launch_bounds__(block_threads<BT>())
equiv_power_fd_kernel(const T* __restrict__ S, const T* __restrict__ H1,
                      const T* __restrict__ H2,
                      const float* __restrict__ ib1,
                      const float* __restrict__ ib2,
                      float* __restrict__ pow_part,
                      float* __restrict__ th_part, int BP, int KP, int DP,
                      int TtP, int Tt, int fc) {
  constexpr int NT = block_threads<BT>();
  constexpr int R = NT / DT;         // interleaved K groups
  constexpr int NO = BT * DT;        // outputs per tile
  constexpr int G = NT / NO;         // threads sharing one output
  constexpr int LPO = NO < 32 ? 32 / NO : 1;   // of them in one warp
  constexpr int G2 = NO < 32 ? G / LPO : 0;    // groups after the warp step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t row = (size_t)BT * KP;                  // one bin's elements
  T* stage = reinterpret_cast<T*>(smem_raw);           // [fc][BT][KP]
  // fc * row * sizeof(T) is a multiple of 256 bytes (KP % 128 == 0)
  float* th = reinterpret_cast<float*>(smem_raw + fc * row * sizeof(T));
  float* red = th + (size_t)Tt * NO;                   // [2][R][NO]
  float* red2 = red + 2 * R * NO;                      // [2][G2][NO]
  float* brbi = red2 + 2 * G2 * NO;                    // [2][NO]

  const int tid = threadIdx.x;
  const int dx = tid % DT, r = tid / DT;     // product role
  const int o = tid % NO, g = tid / NO;      // reduction/accumulate role
  const int b0 = blockIdx.x * BT;
  const int chunk = blockIdx.z, f0 = chunk * fc;
  const int KR = KP / R;                     // a multiple of U
  const size_t plane = (size_t)KP * DP;
  const size_t out_plane = (size_t)BP * DP;

  // the block's S chunk, once: fc runs of BT*KP contiguous elements
  {
    const int vpr = (int)(row * sizeof(T) / 16);       // 16-byte vectors
    uint4* dst = reinterpret_cast<uint4*>(stage);
    for (int i = tid; i < fc * vpr; i += NT) {
      const int fl = i / vpr;
      const uint4* src = reinterpret_cast<const uint4*>(
          S + ((size_t)(f0 + fl) * BP + b0) * KP);
      dst[i] = src[i - fl * vpr];
    }
  }
  // each (t, o) accumulator has one owner thread (t = g, g + G, ...): it
  // alone zeroes, updates, writes out and clears it
  for (int i = tid; i < Tt * NO; i += NT) th[i] = 0.f;
  __syncthreads();

  for (int tile = blockIdx.y; tile < DP / DT; tile += gridDim.y) {
    const int d0 = tile * DT;
    const T* h1 = H1 + d0 + dx;
    const T* h2 = H2 + d0 + dx;
    float pw = 0.f;                          // Parseval sum, held by tid < NO

    for (int fl = 0; fl < fc; ++fl) {
      const size_t f = (size_t)(f0 + fl);
      const T* srow = stage + fl * row;
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
            const float sv = to_f(srow[b * KP + k]);
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

      // reduce the R K-group partials as K1 does: with every thread and
      // warp shuffles where a tile has fewer than 32 outputs, by the NO
      // owner threads otherwise
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

      // tail/head inverse-DFT samples, folded in while Br/Bi are live
      const float br = brbi[o], bi = brbi[NO + o];
      const float* i1 = ib1 + f * TtP;
      const float* i2 = ib2 + f * TtP;
      for (int t = g; t < Tt; t += G)
        th[t * NO + o] = fmaf(i1[t], br, fmaf(i2[t], bi, th[t * NO + o]));
      // no barrier needed here: the next bin writes red, then passes a
      // barrier before brbi is rewritten, and every thread has read brbi
      // before it reaches that barrier
    }

    // this chunk's partials of the tile
    const size_t cell = (size_t)(b0 + o / DT) * DP + d0 + o % DT;
    if (tid < NO) pow_part[chunk * out_plane + cell] = pw;
    for (int t = g; t < Tt; t += G) {
      th_part[((size_t)chunk * Tt + t) * out_plane + cell] = th[t * NO + o];
      th[t * NO + o] = 0.f;
    }
  }
}

// The finish: a block per (frame tile, 8-direction tile), as K1's
// epilogue, in three steps with a barrier between them:
// 1. every thread takes (t, o) pairs of the tile's Tt x NO tail/head
//    samples and sums their partials in chunk order into shared memory;
// 2. every thread takes (c, dx) pairs of the head corrections and forms
//    v = sj . Wc3 for all BT frames of the tile at once from their sj rows
//    in shared memory, so each Wc3 element is loaded once per frame tile
//    and feeds BT FMAs; it leaves v^2 - 2 TH v in place of TH;
// 3. thread (o, g) sums the tail squares and those terms for
//    t = g, g + FG, ...; the FG partial sums and the chunks' Parseval
//    partials reduce in a fixed order.
// Steps 1 and 2 spread the loads over all threads, each with several in
// flight: one owner thread per output looping over everything was bound by
// the latency of its serial loads.
template <int BT>
__global__ void __launch_bounds__(FIN_THREADS)
equiv_power_fd_finish(const float* __restrict__ pow_part,
                      const float* __restrict__ th_part,
                      const float* __restrict__ sj,
                      const float* __restrict__ wc3,
                      float* __restrict__ out, int BP, int DP, int n_fc,
                      int n_tail, int Tc, int JMP, float inv) {
  constexpr int NO = BT * DT;                  // outputs per block
  constexpr int FG = FIN_THREADS / NO;         // threads sharing one output
  extern __shared__ float fsm[];
  // sj rows at a stride of JMP + 1 floats
  const int JS = JMP + 1;
  const int Tt = n_tail + Tc;
  float* srows = fsm;                          // [BT][JS]
  float* th = srows + (size_t)BT * JS;         // [Tt][NO]
  float* red = th + (size_t)Tt * NO;           // [FG][NO]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * BT, d0 = blockIdx.x * DT;
  const size_t out_plane = (size_t)BP * DP;

  for (int i = tid; i < BT * JMP; i += FIN_THREADS)
    srows[(i / JMP) * JS + i % JMP] = sj[(size_t)b0 * JMP + i];
  for (int i = tid; i < Tt * NO; i += FIN_THREADS) {
    const int t = i / NO, oi = i % NO;
    const float* p = th_part + (size_t)t * out_plane +
                     (size_t)(b0 + oi / DT) * DP + d0 + oi % DT;
    float x = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_fc; ++c) x += p[(size_t)c * Tt * out_plane];
    th[i] = x;
  }
  __syncthreads();

  for (int i = tid; i < Tc * DT; i += FIN_THREADS) {
    const int c = i / DT, dx = i % DT;
    const float* w = wc3 + (size_t)c * DP + d0 + dx;
    float v[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) v[b] = 0.f;
#pragma unroll 8
    for (int j = 0; j < JMP; ++j) {
      const float wj = w[(size_t)j * Tc * DP];
#pragma unroll
      for (int b = 0; b < BT; ++b) v[b] = fmaf(srows[b * JS + j], wj, v[b]);
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float* h = th + (size_t)(n_tail + c) * NO + b * DT + dx;
      *h = v[b] * v[b] - 2.f * *h * v[b];
    }
  }
  __syncthreads();

  const int o = tid % NO, g = tid / NO;
  const size_t cell = (size_t)(b0 + o / DT) * DP + d0 + o % DT;
  float acc = 0.f;
  for (int t = g; t < Tt; t += FG) {
    const float y = th[t * NO + o];
    acc = t < n_tail ? fmaf(-y, y, acc) : acc + y;
  }
  red[g * NO + o] = acc;
  __syncthreads();
  if (tid < NO) {
    float pw = 0.f;
    for (int c = 0; c < n_fc; ++c) pw += pow_part[c * out_plane + cell];
    float total = 0.f;
    for (int q = 0; q < FG; ++q) total += red[q * NO + tid];
    out[cell] = (pw + total) * inv;
  }
}

template <typename T>
using ChunkKernel = void (*)(const T*, const T*, const T*, const float*,
                             const float*, float*, float*, int, int, int,
                             int, int, int);

// The chunk kernel for this K (rows in batches of 8 where K allows, as at
// the reference shape's K = 512, else of 2) and its shared memory, opted
// in above 48 KB.
template <typename T, int BT>
cudaError_t chunk_kernel(int KP, int fc, int Tt, ChunkKernel<T>* kern,
                         size_t* smem) {
  constexpr int R = block_threads<BT>() / DT;
  *kern = (KP / R) % 8 == 0 ? equiv_power_fd_kernel<T, BT, 8>
                            : equiv_power_fd_kernel<T, BT, 2>;
  *smem = (size_t)fc * BT * KP * sizeof(T) +
          sizeof(float) * work_floats<BT>(Tt);
  return cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// Blocks of the chunk kernel one SM holds (its registers, shared memory
// and threads together), or a negated cudaError_t.
template <typename T, int BT>
int blocks_per_sm(int KP, int fc, int Tt) {
  ChunkKernel<T> kern;
  size_t smem;
  int n = 0;
  cudaError_t e = chunk_kernel<T, BT>(KP, fc, Tt, &kern, &smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, block_threads<BT>(), smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, int BT>
int launch(const void* S, const void* H1, const void* H2, const float* ib1,
           const float* ib2, const float* sj, const float* wc3,
           float* pow_part, float* th_part, float* out, int FP, int BP,
           int KP, int DP, int TtP, int n_tail, int Tc, int JMP, int n_fc,
           int n_dg, float inv, cudaStream_t stream) {
  constexpr int NT = block_threads<BT>();
  const int Tt = n_tail + Tc, fc = FP / n_fc;
  ChunkKernel<T> kern;
  size_t smem;
  cudaError_t e = chunk_kernel<T, BT>(KP, fc, Tt, &kern, &smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BP / BT, n_dg, n_fc);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(H1),
      static_cast<const T*>(H2), ib1, ib2, pow_part, th_part, BP, KP, DP,
      TtP, Tt, fc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // sj rows, the Tt x BT*8 tail/head sums and the FG x BT*8 partials
  const int jm = Tc > 0 ? JMP : 0;
  const size_t fsmem =
      sizeof(float) * ((size_t)BT * (jm + 1) + (size_t)Tt * BT * DT +
                       (size_t)FIN_THREADS);
  e = cudaFuncSetAttribute(equiv_power_fd_finish<BT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)fsmem);
  if (e != cudaSuccess) return (int)e;
  equiv_power_fd_finish<BT><<<dim3(DP / DT, BP / BT), FIN_THREADS, fsmem,
                              stream>>>(pow_part, th_part, sj, wc3, out, BP,
                                        DP, n_fc, n_tail, Tc, jm, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int bt, const void* S, const void* H1, const void* H2,
             const float* ib1, const float* ib2, const float* sj,
             const float* wc3, float* pp, float* tp, float* out, int FP,
             int BP, int KP, int DP, int TtP, int n_tail, int Tc, int JMP,
             int n_fc, int n_dg, float inv, cudaStream_t st) {
  switch (bt) {
    case 1: return launch<T, 1>(S, H1, H2, ib1, ib2, sj, wc3, pp, tp, out,
                                FP, BP, KP, DP, TtP, n_tail, Tc, JMP, n_fc,
                                n_dg, inv, st);
    case 2: return launch<T, 2>(S, H1, H2, ib1, ib2, sj, wc3, pp, tp, out,
                                FP, BP, KP, DP, TtP, n_tail, Tc, JMP, n_fc,
                                n_dg, inv, st);
    case 4: return launch<T, 4>(S, H1, H2, ib1, ib2, sj, wc3, pp, tp, out,
                                FP, BP, KP, DP, TtP, n_tail, Tc, JMP, n_fc,
                                n_dg, inv, st);
    case 8: return launch<T, 8>(S, H1, H2, ib1, ib2, sj, wc3, pp, tp, out,
                                FP, BP, KP, DP, TtP, n_tail, Tc, JMP, n_fc,
                                n_dg, inv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// S (FP, BP, KP), H1/H2 (FP, KP, DP): float32 (bf16 == 0) or bf16
// (bf16 == 1), S 16-byte aligned.  ib1/ib2 (FP, TtP) f32; sj (BP, JMP) f32
// and wc3 (JMP, Tc, DP) f32 when Tc > 0 (may be null otherwise);
// pow_part (n_fc, BP, DP) and th_part (n_fc, n_tail + Tc, BP, DP) f32
// scratch; out (BP, DP) f32.  FP % n_fc == 0, KP % 128 == 0, DP % 8 == 0,
// BP % bt == 0.  Returns a cudaError_t.
int zrt_equiv_power_fd(const void* S, const void* H1, const void* H2,
                       const float* ib1, const float* ib2, const float* sj,
                       const float* wc3, float* pow_part, float* th_part,
                       float* out, int FP, int BP, int KP, int DP, int TtP,
                       int n_tail, int Tc, int JMP, int n_fc, int n_dg,
                       float inv, int bf16, int bt, void* stream) {
  if (bt <= 0 || n_fc <= 0 || n_dg <= 0 || FP % n_fc || KP % 128 ||
      DP % DT || BP % bt || n_tail + Tc > TtP ||
      (Tc > 0 && (sj == nullptr || wc3 == nullptr || JMP <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(bt, S, H1, H2, ib1, ib2, sj, wc3,
                                   pow_part, th_part, out, FP, BP, KP, DP,
                                   TtP, n_tail, Tc, JMP, n_fc, n_dg, inv, st);
  return dispatch<float>(bt, S, H1, H2, ib1, ib2, sj, wc3, pow_part,
                         th_part, out, FP, BP, KP, DP, TtP, n_tail, Tc, JMP,
                         n_fc, n_dg, inv, st);
}

// Blocks of the chunk kernel for frame tile bt, fc bins a chunk and
// n_tail + Tc = Tt that one SM of the current device holds at once; a
// negated cudaError_t on failure.
int zrt_equiv_power_fd_blocks_per_sm(int KP, int fc, int Tt, int bf16,
                                     int bt) {
  if (KP % 128 || fc <= 0 || Tt <= 0) return -(int)cudaErrorInvalidValue;
  switch (bt * 2 + (bf16 ? 1 : 0)) {
    case 2: return blocks_per_sm<float, 1>(KP, fc, Tt);
    case 3: return blocks_per_sm<__nv_bfloat16, 1>(KP, fc, Tt);
    case 4: return blocks_per_sm<float, 2>(KP, fc, Tt);
    case 5: return blocks_per_sm<__nv_bfloat16, 2>(KP, fc, Tt);
    case 8: return blocks_per_sm<float, 4>(KP, fc, Tt);
    case 9: return blocks_per_sm<__nv_bfloat16, 4>(KP, fc, Tt);
    case 16: return blocks_per_sm<float, 8>(KP, fc, Tt);
    case 17: return blocks_per_sm<__nv_bfloat16, 8>(KP, fc, Tt);
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
