// Fused time-domain steered power (delay-and-sum family) for Hopper.
//
// Replaces the Pallas TPU kernels of
// zybo_rt_sampler_image_detection_tpu/ops/pallas_kernels.py:
//   _power_kernel         (K2, full delay-line scratch)
//   _power_kernel_tchunk  (K3, the tap axis in chunks)
//   _power_kernel_window  (K4, per-tile tap windows)
// with one kernel over per-(window tile, mic) tap windows; a plan whose
// windows span all T taps (bases 0) is the dense contraction of K2/K3.  It
// computes the same function, not the same blocks.  For frame b and
// direction d, with mic m's window starting at base[tile(d), m] and TK
// taps wide:
//
//   beam[n]  = sum_{m, j<TK} w[m*TK + j, d] * s[b, m, n - tau_min - base - j]
//   out[b,d] = sum_{n<N} (beam[n] - v[b, d, n] [n < Tc])^2 * inv
//
// with s zero outside [0, N) (the C pad_delay semantics, per frame) and v
// the head corrections: v[b, d, c] = sum over row d*Tc + c of the sparse
// list of val * sj[b, idx].
//
// What bounds it on an H100: the work the maps need is 2*N FLOP per
// nonzero weight and frame.  At the reference shape (Config(), lerp:
// D=1824, T=49, M=256, N=256) lerp has 2 nonzero taps of 49 per
// (direction, mic): about 0.48 GFLOP a frame, >= 7 us at the 67 TFLOP/s of
// FP32 on the CUDA cores, against about 4 MB of signal and nonzero weights
// (1.2 us at 3.35 TB/s): bound by operations.  The kernel multiplies dense
// windows: at 8 directions a window Tw = 5 for lerp (2.5x the needed
// work), 11 for hybrid (1.4x).
//
// What the design does about it:
// * Windows of 8 directions: each (8-direction tile, mic) runs over the Tw
//   taps that hold its nonzero weights (tile_d 16/32 share one window
//   across 2/4 warp tiles).
// * Padded signal rows: the host writes each frame's rows into (M, NL)
//   with zero margins wide enough that every shifted read of every window
//   lies inside the row.  A stage copies whole rows (MG mics of one frame
//   are one contiguous run) with 16-byte cp.async, no bounds checks and no
//   conversion; each warp applies its window's shift when it reads shared
//   memory.  Neither the delay lines nor the (B, D, N) beams reach device
//   memory (the TPU kernel's property).
// * A block is one frame x G warp tiles x NS sample splits.  All its warps
//   read the same staged rows, each at its own tile's bases, so a frame is
//   staged DP/(8G) times.  Warp (g, q) owns 8 directions and the samples
//   n = n0 + 32*NI*q + lane + 32*i; per k step a lane reads NI row values
//   (consecutive lanes, consecutive addresses: no bank conflicts) and 8
//   weights (broadcast 16-byte loads) and does 8*NI FMAs from registers.
//   NS > 1 (split samples) keeps the card full at one frame; the squares
//   are summed per split and the splits added in a fixed order.
// * Staging overlaps the product: two buffers of (MG rows, G weight
//   tiles); group k+1 is copied while group k is multiplied, with one
//   barrier per group.  Staged weights (broadcast shared-memory loads)
//   beat warp-uniform 16-byte loads from device memory at every block
//   split timed (PERF.md, PR 6).
// * Corrections from the sparse list: before the K loop each thread takes
//   rows (d, c) of the block's directions and sums val * sj over the row
//   (eight entries' loads in flight, sj staged in shared memory); the
//   epilogue subtracts them on the first Tc samples, squares and sums over
//   n (lanes, then warp shuffles).  No dense correction table and no
//   (B, cc, DP) intermediate.
// * A block owns whole outputs: no atomics, deterministic results.
// * Precision: FP32 operands (modes f32/high) or bf16 operands (mode bf16,
//   widened to FP32 as they are read, which is exact), FP32 sums.  Plain
//   FMAs on the CUDA cores: no tensor cores.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DW = 8;             // directions per warp tile
constexpr int MAX_WARPS = 8;      // warps a block (G x NS)
constexpr int MIN_BLOCKS = 2;     // registers for 16 warps an SM
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive weights as floats (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&w)[DW]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&w)[DW]) {
  // a bf16 is the high half of its float: widening is a shift, exact
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[2 * k] = __uint_as_float(v[k] << 16);
    w[2 * k + 1] = __uint_as_float(v[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

size_t r16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of one block's shared memory: two stages of rows [MG][NL]
// and weights [G][MG*TK][8] (plane type), then the bases [G][M] (int),
// the frame's sj row [JM], the corrections [G][Tc][8] and the per-split
// sums [G][NS][8] (float).  Mirrored by fused_kernel.smem_bytes.
struct Layout {
  size_t rows, wts, bases, sj, corr, red, total;
};

Layout layout(int isz, int NL, int TK, int M, int JM, int Tc, int G, int NS,
              int MG) {
  Layout L;
  L.rows = 0;
  L.wts = L.rows + r16((size_t)2 * MG * NL * isz);
  L.bases = L.wts + r16((size_t)2 * G * MG * TK * DW * isz);
  L.sj = L.bases + r16((size_t)G * M * 4);
  L.corr = L.sj + r16((size_t)JM * 4);
  L.red = L.corr + r16((size_t)G * Tc * DW * 4);
  L.total = L.red + r16((size_t)G * NS * DW * 4);
  return L;
}

template <typename T, int NI>
__global__ void __launch_bounds__(MAX_WARPS * 32, MIN_BLOCKS)
time_power_kernel(const T* __restrict__ s, const T* __restrict__ w,
                  const int* __restrict__ bases,
                  const float* __restrict__ sj,
                  const int* __restrict__ wc_ptr,
                  const int* __restrict__ wc_idx,
                  const float* __restrict__ wc_val, float* __restrict__ out,
                  Layout L, int M, int N, int NL, int lpad, int TK, int DP,
                  int tile_d, int tau_min, int Tc, int JM, int G, int NS,
                  int MG, float inv) {
  constexpr int NW = 32 * NI;                 // samples of a warp a pass
  constexpr int CH = 16 / sizeof(T);          // elements of a 16-byte chunk
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  T* rows = reinterpret_cast<T*>(sm + L.rows);
  T* wts = reinterpret_cast<T*>(sm + L.wts);
  int* bs = reinterpret_cast<int*>(sm + L.bases);
  float* sjs = reinterpret_cast<float*>(sm + L.sj);
  float* cs = reinterpret_cast<float*>(sm + L.corr);
  float* red = reinterpret_cast<float*>(sm + L.red);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int gi = warp / NS, si = warp - gi * NS;
  const int b = blockIdx.y;
  const int n_t8 = DP / DW;
  const int t0 = blockIdx.x * G;              // the block's first warp tile
  const int gt = min(G, n_t8 - t0);           // warp tiles it holds
  const bool active = gi < gt;
  const int ng = (M + MG - 1) / MG;           // mic groups
  const int NB = NW * NS;                     // samples of the block a pass
  const int n_stage = (N + NB - 1) / NB * ng;
  const size_t row_stage = (size_t)MG * NL;
  const size_t w_tile = (size_t)MG * TK * DW;

  // stage q (mic group q % ng) into buffer q & 1: MG rows of frame b, one
  // contiguous run, and the 8 weights of each warp tile for each of the
  // group's MG*TK weight rows
  auto stage = [&](int q) {
    const int m0 = (q % ng) * MG, mg = min(MG, M - m0);
    const int buf = q & 1;
    const char* src = reinterpret_cast<const char*>(
        s + ((size_t)b * M + m0) * NL);
    char* dst = reinterpret_cast<char*>(rows + buf * row_stage);
    const int n_rows = mg * NL / CH;
    for (int c = tid; c < n_rows; c += nthreads)
      cp_async16(dst + 16 * c, src + 16 * c);
    constexpr int CPR = DW / CH;              // chunks of 8 weights
    const int wr = mg * TK;
    const int n_w = gt * wr * CPR;
    T* wd = wts + buf * G * w_tile;
    for (int c = tid; c < n_w; c += nthreads) {
      const int k = c % CPR, r = (c / CPR) % wr, tile = c / (CPR * wr);
      cp_async16(wd + tile * w_tile + (size_t)r * DW + k * CH,
                 w + ((size_t)m0 * TK + r) * DP + (size_t)(t0 + tile) * DW +
                     k * CH);
    }
    cp_async_commit();
  };

  stage(0);

  // the bases of the block's warp tiles (each its window tile's row) and
  // the frame's sj row.  A base past lpad - tau_min - TK + 1 would read
  // outside the padded row: the block then writes NaN and stops.
  const int bmax = lpad - tau_min - TK + 1;
  int bad = 0;
  for (int i = tid; i < G * M; i += nthreads) {
    const int tile = i / M, m = i - tile * M;
    int v = 0;
    if (tile < gt) {
      v = __ldg(bases + (size_t)((t0 + tile) * DW / tile_d) * M + m);
      bad |= v < 0 || v > bmax;
    }
    bs[i] = v;
  }
  for (int i = tid; i < JM; i += nthreads)
    sjs[i] = __ldg(sj + (size_t)b * JM + i);
  if (__syncthreads_or(bad)) {
    cp_async_wait_all();
    if (tid < gt * DW)
      out[(size_t)b * DP + t0 * DW + tid] = __int_as_float(0x7fc00000);
    return;
  }

  // the corrections of rows (d, c < Tc) of the block's directions, one
  // thread a row, eight entries' loads in flight (a row may hold hundreds)
  for (int i = tid; i < gt * Tc * DW; i += nthreads) {
    const int tile = i / (Tc * DW), rem = i - tile * Tc * DW;
    const int c = rem / DW, dd = rem - c * DW;
    const int r = ((t0 + tile) * DW + dd) * Tc + c;
    const int e1 = __ldg(wc_ptr + r + 1);
    int e = __ldg(wc_ptr + r);
    float v = 0.f;
    for (; e + 8 <= e1; e += 8) {
      int j[8];
      float wv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        j[q] = __ldg(wc_idx + e + q);
        wv[q] = __ldg(wc_val + e + q);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) v = fmaf(sjs[j[q]], wv[q], v);
    }
    for (; e < e1; ++e) v = fmaf(sjs[__ldg(wc_idx + e)], __ldg(wc_val + e), v);
    cs[i] = v;                                // [tile][c][dd]
  }

  const int* my_bases = bs + gi * M;
  float psum[DW];
#pragma unroll
  for (int dd = 0; dd < DW; ++dd) psum[dd] = 0.f;
  float acc[NI][DW];

  for (int q = 0; q < n_stage; ++q) {
    const int g = q % ng, m0 = g * MG, mg = min(MG, M - m0);
    const int n0 = (q / ng) * NB + si * NW;   // the warp's first sample
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int dd = 0; dd < DW; ++dd) acc[i][dd] = 0.f;
    }
    cp_async_wait_all();
    // stage q is visible, and every warp is done with buffer (q + 1) & 1
    __syncthreads();
    if (q + 1 < n_stage) stage(q + 1);
    if (active) {
      const T* rb = rows + (q & 1) * row_stage + lpad - tau_min + n0 + lane;
      const T* wb = wts + (q & 1) * G * w_tile + gi * w_tile;
      for (int mm = 0; mm < mg; ++mm) {
        // row index of sample n at tap j: lpad + n - tau_min - base - j
        const T* xr = rb + (size_t)mm * NL - my_bases[m0 + mm];
        const T* wr = wb + (size_t)mm * TK * DW;
#pragma unroll 2
        for (int j = 0; j < TK; ++j) {
          float wv[DW];
          load8(wr + j * DW, wv);
          const T* xj = xr - j;
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float xv = to_f(xj[32 * i]);
#pragma unroll
            for (int dd = 0; dd < DW; ++dd)
              acc[i][dd] = fmaf(xv, wv[dd], acc[i][dd]);
          }
        }
      }
      if (g == ng - 1) {
        // this pass's samples: subtract the corrections, square, sum
        const float* cw = cs + (size_t)gi * Tc * DW;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int n = n0 + lane + 32 * i;
          if (n < N) {
#pragma unroll
            for (int dd = 0; dd < DW; ++dd) {
              const float v =
                  acc[i][dd] - (n < Tc ? cw[n * DW + dd] : 0.f);
              psum[dd] = fmaf(v, v, psum[dd]);
            }
          }
        }
      }
    }
  }

  // the warp's sums over its lanes, then the sample splits in order
#pragma unroll
  for (int dd = 0; dd < DW; ++dd)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum[dd] += __shfl_xor_sync(0xffffffffu, psum[dd], o);
  if (lane == 0) {
#pragma unroll
    for (int dd = 0; dd < DW; ++dd) red[(gi * NS + si) * DW + dd] = psum[dd];
  }
  __syncthreads();
  if (tid < gt * DW) {
    const int tile = tid / DW, dd = tid - tile * DW;
    float total = 0.f;
    for (int k = 0; k < NS; ++k) total += red[(tile * NS + k) * DW + dd];
    out[(size_t)b * DP + (t0 + tile) * DW + dd] = total * inv;
  }
}

template <typename T, int NI>
int launch(const void* s, const void* w, const int* bases, const float* sj,
           const int* wc_ptr, const int* wc_idx, const float* wc_val,
           float* out, const Layout& L, int BP, int M, int N, int NL,
           int lpad, int TK, int DP, int tile_d, int tau_min, int Tc, int JM,
           int G, int NS, int MG, float inv, cudaStream_t stream) {
  auto kern = time_power_kernel<T, NI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int n_t8 = DP / DW;
  dim3 grid((n_t8 + G - 1) / G, BP);
  kern<<<grid, G * NS * 32, L.total, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(w), bases, sj, wc_ptr,
      wc_idx, wc_val, out, L, M, N, NL, lpad, TK, DP, tile_d, tau_min, Tc,
      JM, G, NS, MG, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int NI, const void* s, const void* w, const int* bases,
             const float* sj, const int* wc_ptr, const int* wc_idx,
             const float* wc_val, float* out, const Layout& L, int BP, int M,
             int N, int NL, int lpad, int TK, int DP, int tile_d,
             int tau_min, int Tc, int JM, int G, int NS, int MG, float inv,
             cudaStream_t st) {
#define ZRT_LAUNCH(ni)                                                       \
  launch<T, ni>(s, w, bases, sj, wc_ptr, wc_idx, wc_val, out, L, BP, M, N, \
                NL, lpad, TK, DP, tile_d, tau_min, Tc, JM, G, NS, MG, inv,   \
                st)
  switch (NI) {
    case 2: return ZRT_LAUNCH(2);
    case 4: return ZRT_LAUNCH(4);
    case 8: return ZRT_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZRT_LAUNCH
}

}  // namespace

extern "C" {

// s (BP, M, NL): frame b's mic m at row element lpad + n (n < N), zero
// elsewhere; w (M*TK, DP): float32 (bf16 == 0) or bf16 (bf16 == 1), both
// 16-byte aligned; bases (DP / tile_d, M) int32: mic m's window in window
// tile i starts at tap bases[i * M + m]; sj (BP, JM) f32 and the sparse
// list wc_ptr (DP*Tc + 1) / wc_idx / wc_val over rows d*Tc + c, or all
// null with Tc == 0; out (BP, DP) f32.  tile_d in {8, 16, 32} divides DP;
// a block is G warp tiles x NS sample splits (G*NS <= 8), NI in {2, 4, 8}
// samples a lane, MG mics a stage.  NL must hold every read: NL*size % 16
// == 0, lpad >= tau_min + TK - 1 and NL >= lpad - tau_min + the samples
// the passes cover.  Returns a cudaError_t.
int zrt_time_power(const void* s, const void* w, const int* bases,
                   const float* sj, const int* wc_ptr, const int* wc_idx,
                   const float* wc_val, float* out, int BP, int M, int N,
                   int NL, int lpad, int TK, int DP, int tile_d, int tau_min,
                   int Tc, int JM, int G, int NS, int MG, int NI, float inv,
                   int bf16, void* stream) {
  const int isz = bf16 ? 2 : 4;
  const int NB = 32 * NI * NS;
  const long cover = (long)(N + NB - 1) / NB * NB;
  if (!(tile_d == 8 || tile_d == 16 || tile_d == 32) || DP % tile_d ||
      s == nullptr || w == nullptr || bases == nullptr || out == nullptr ||
      BP <= 0 || BP > 65535 || M <= 0 || N <= 0 || TK <= 0 || G <= 0 ||
      NS <= 0 || G * NS > MAX_WARPS || MG <= 0 ||
      (NL * isz) % 16 || lpad < 0 || lpad - tau_min - TK + 1 < 0 ||
      (long)NL < lpad - tau_min + cover || Tc < 0 || Tc > N ||
      (Tc > 0 && (sj == nullptr || wc_ptr == nullptr || wc_idx == nullptr ||
                  wc_val == nullptr || JM <= 0)) ||
      reinterpret_cast<uintptr_t>(s) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(isz, NL, TK, M, Tc ? JM : 0, Tc, G, NS, MG);
  if (L.total > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(NI, s, w, bases, sj, wc_ptr, wc_idx,
                                   wc_val, out, L, BP, M, N, NL, lpad, TK,
                                   DP, tile_d, tau_min, Tc, Tc ? JM : 0, G,
                                   NS, MG, inv, st);
  return dispatch<float>(NI, s, w, bases, sj, wc_ptr, wc_idx, wc_val,
                         out, L, BP, M, N, NL, lpad, TK, DP, tile_d, tau_min,
                         Tc, Tc ? JM : 0, G, NS, MG, inv, st);
}

// Shared-memory bytes of one block (the Python plan mirrors it).
long zrt_time_power_smem(int bf16, int NL, int TK, int M, int JM, int Tc,
                         int G, int NS, int MG) {
  return (long)layout(bf16 ? 2 : 4, NL, TK, M, JM, Tc, G, NS, MG).total;
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
