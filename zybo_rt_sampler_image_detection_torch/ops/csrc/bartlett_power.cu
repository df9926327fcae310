// The FFT route's Bartlett contraction in one kernel:
//
//   P[b, d] = sum_f w_f |sum_m X[b, adaptive[m], bins[f]] . phase[f, m, d]|^2
//
// in FP32 on the CUDA cores, straight from the rfft of the batch as the
// stage hands it (B, C, N/2 + 1) complex64: the channel gather, the band
// and the per-bin weights are indices and scales inside the kernel, so no
// gathered, band-sliced or per-bin copy is ever written.
//
// It replaces no TPU kernel: the JAX package leaves this contraction to
// XLA.  It exists because the library chain it replaced (gather, band
// copy, one batched complex GEMM, |.|^2, the bin sum) wrote and re-read
// (F, B, M) spectra and (F, B, D) products, and its GEMM streamed the
// steering tensor at a quarter of HBM's rate.
//
// What bounds it on an H100: the steering tensor's bytes (32.5 MB at the
// web app's shape, 9.7 us at 3.35 TB/s) and, at 16 frames, its FP32 FMAs
// about as much (0.52 GFLOP, 7.8 us at 67 TFLOP/s): each complex element
// read feeds 16 frames, 16 flops a byte, near the card's ridge of 20.
// So the tensor is read exactly once and its FMAs overlap the stream:
//
// * ops/bartlett_kernel.py lays the tensor out once, at table
//   construction, as (NC, F, M, DC) direction chunks padded with zeros to
//   DC, a multiple of 16 (the rows as stored are 1,352 bytes apart, which
//   a bulk copy cannot tile).  One block's MC steering rows of one bin
//   are then one contiguous bulk copy.
// * A block owns one bin, one direction chunk and one frame tile of BT
//   frames, over all the mics (94 blocks at the web app's shape).  A ring
//   of stages, each MC steering rows of the bin, is kept full with bulk
//   copies, each completing on the stage's mbarrier: the last warp to
//   release a stage (by a ticket) refills it, so no warp waits on the
//   others to copy.  No warp is set aside for the copies: 12 warps of
//   FMAs keep 168 registers a thread.  The ring is as deep as the card's
//   shared memory allows (at most MAX_STAGES), worked out at launch.
// * The frames' spectra of a stage's mics (through adaptive and bins, zero
//   past the batch) are gathered with 8-byte cp.async copies, a request a
//   value, by one warp in turn, three stages ahead of the FMAs, each stage
//   on its own mbarrier.  Few such requests are in flight at once: all of
//   a bin's 4,096 at once stall the shared-memory loads of the FMAs behind
//   them.
// * A thread holds 8 frames x 4 directions of Y = sum_m S P in registers
//   (at 16 frames): 128 FMAs for six 16-byte shared loads a row.  A warp
//   covers 64 directions, so a chunk takes at most three warps; four
//   groups of such warps split each stage's rows.  After the last stage the
//   groups' partial Y meet in shared memory, and every thread sums its share of
//   them in group order, squares and weights it.
// * Each bin writes its map (F, B, D); a second small kernel sums them in
//   bin order.  No float atomics: every sum has a fixed order, so the
//   output is bitwise repeatable from call to call.
//
// ops/bartlett_kernel.py picks the frame tile and lays out the tensor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "equiv_core.cuh"

namespace {

using zrt_equiv::bar_arrive;
using zrt_equiv::bar_expect;
using zrt_equiv::bar_init;
using zrt_equiv::bar_init_fence;
using zrt_equiv::bar_wait;
using zrt_equiv::bulk_load;
using zrt_equiv::fence_async_shared;
using zrt_equiv::smem_addr;

constexpr int MC = 16;           // steering rows (mics) of one ring stage
constexpr int KS = 4;            // warp groups splitting a stage's rows
constexpr int RG = MC / KS;      // rows of a stage a warp group takes
constexpr int MAX_STAGES = 6;
constexpr int NQ = 16;           // ring stages of a bin (M <= NQ * MC)
constexpr int LOOK = 3;          // stages the spectra gather runs ahead
constexpr int HEAD = 384;        // bytes of mbarriers and tickets
constexpr int WD = 64;           // directions of a warp
constexpr int MAX_WARPS = KS * 3;       // DC <= 192

// A warp's lanes: FL frame lanes x DL direction-pair lanes; a
// thread owns FPT frames x NP direction pairs, the pairs 2 DL directions
// apart (so each 16-byte load of the warp is one contiguous run).
template <int BT>
struct Tile {
  static constexpr int FPT = BT < 8 ? BT : 8;
  static constexpr int FL = BT / FPT;
  static constexpr int DL = 32 / FL;
  static constexpr int NP = WD / (2 * DL);
};

// shared memory of a block: the mbarriers (full[6], empty[6],
// spectra[NQ]) and the stages' tickets (int[6]), then in float2 the ring
// of ns stages of MC steering rows, [MC][DC]; the bin's spectra, [M][BT];
// the warp groups' partial Y, [KS][BT][DC]
inline size_t smem_bytes(int BT, int DC, int M, int ns) {
  return HEAD + ((size_t)ns * MC * DC + (size_t)M * BT +
                 (size_t)KS * BT * DC) * 8;
}

// 8 bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies landed
// (counted in the barrier's initial count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// The spectra of one ring stage's mics (rows r0 .. r0 + rows) for the
// tile's frames, [rows][BT] at dst: one warp's cp.async copies, completing
// on bar (32 arrivals).
template <int BT>
__device__ __forceinline__ void gather_stage(float2* dst, uint64_t* bar,
                                             const float2* X,
                                             const int* adaptive, int bin,
                                             int r0, int rows, int C, int NF,
                                             int B, int b0, int lane) {
  for (int e = lane; e < rows * BT; e += 32) {
    const int m = r0 + e / BT, bg = b0 + e % BT;
    const bool ok = bg < B;
    const float2* src =
        ok ? X + ((size_t)bg * C + adaptive[m]) * NF + bin : X;
    cp_async8(dst + e, src, ok ? 8 : 0);
  }
  cp_async_arrive(bar);
}

// One steering row m: Y[i][x] += S[m, frame i] * P[m, direction x], the
// thread's pairs at P + po[q].
template <int FPT, int NP>
__device__ __forceinline__ void fma_row(const float2* S, const float2* P,
                                        const int (&po)[NP],
                                        float (&yr)[FPT][2 * NP],
                                        float (&yi)[FPT][2 * NP]) {
  float4 p[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q)
    p[q] = *reinterpret_cast<const float4*>(P + po[q]);
  float sr[FPT], si[FPT];
  if constexpr (FPT == 1) {
    const float2 s = *S;
    sr[0] = s.x;
    si[0] = s.y;
  } else {
#pragma unroll
    for (int i = 0; i < FPT; i += 2) {
      const float4 s = *reinterpret_cast<const float4*>(S + i);
      sr[i] = s.x;
      si[i] = s.y;
      sr[i + 1] = s.z;
      si[i + 1] = s.w;
    }
  }
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      float* r = yr[i] + 2 * q;
      float* m = yi[i] + 2 * q;
      r[0] = fmaf(-si[i], p[q].y, fmaf(sr[i], p[q].x, r[0]));
      m[0] = fmaf(si[i], p[q].x, fmaf(sr[i], p[q].y, m[0]));
      r[1] = fmaf(-si[i], p[q].w, fmaf(sr[i], p[q].z, r[1]));
      m[1] = fmaf(si[i], p[q].z, fmaf(sr[i], p[q].w, m[1]));
    }
}

// Block (bin f, direction chunk c, frame tile z); out is (F, B, D).
template <int BT>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
bartlett_power_kernel(const float2* __restrict__ X,
                      const float2* __restrict__ Pt,
                      const int* __restrict__ adaptive,
                      const int* __restrict__ bins,
                      const float* __restrict__ w, float* __restrict__ out,
                      int B, int C, int NF, int F, int M, int D, int DC,
                      int ns) {
  using T = Tile<BT>;
  constexpr int FPT = T::FPT, NP = T::NP;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* sbar = empty + MAX_STAGES;               // [NQ]
  int* ticket = reinterpret_cast<int*>(sbar + NQ);   // [MAX_STAGES]
  float2* ring = reinterpret_cast<float2*>(smem + HEAD);
  float2* sbuf = ring + (size_t)ns * MC * DC;
  float2* ybuf = sbuf + (size_t)M * BT;
  const int nw = (int)(blockDim.x >> 5);           // warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x, c = blockIdx.y, z = blockIdx.z;
  const int nst = (M + MC - 1) / MC;                 // ring stages

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(full + s);
      bar_init(empty + s, nw);         // one arrival a warp
    }
    for (int s = 0; s < NQ; ++s)
      bar_init(sbar + s, 32);          // a warp's copies
    for (int s = 0; s < MAX_STAGES; ++s) ticket[s] = 0;
    bar_init_fence();
  }
  __syncthreads();

  // a thread: warp group k takes rows k * RG .. of each stage;
  // frames fr .. fr + FPT of the tile and NP direction pairs from d0
  // (pairs past the chunk read direction 0 and keep nothing)
  const int tid = threadIdx.x, nct = nw * 32;
  const int nwd = nw / KS, k = warp / nwd;
  const int fr = (lane / T::DL) * FPT;
  const int d0 = (warp % nwd) * WD + 2 * (lane % T::DL);
  int po[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int d = d0 + 2 * T::DL * q;
    po[q] = d < DC ? d : 0;
  }
  const int YS = BT * DC;                            // a warp group's Y

  // the ring: thread 0 copies the first ns stages, and the last warp to
  // release stage s (by its ticket) copies stage s + ns into its slot
  const float2* Pb = Pt + ((size_t)c * F + f) * M * DC;
  auto issue = [&](int s, int slot) {
    const uint32_t bytes = (uint32_t)min(MC, M - s * MC) * DC * 8;
    fence_async_shared();
    bar_expect(full + slot, bytes);
    bulk_load(ring + (size_t)slot * MC * DC, Pb + (size_t)s * MC * DC,
              bytes, full + slot);
  };
  if (tid == 0)
    for (int s = 0; s < min(ns, nst); ++s) issue(s, s);
  // the spectra of stage s: gathered by warp s % nw, `look` stages ahead of
  // the FMAs, so that few copies are in flight at once
  const int bin = bins[f];
  auto gather = [&](int s) {
    const int r0 = s * MC;
    gather_stage<BT>(sbuf + (size_t)r0 * BT, sbar + s, X, adaptive, bin, r0,
                     min(MC, M - r0), C, NF, B, z * BT, lane);
  };
  const int look = min(LOOK, nst);
  for (int s = warp; s < look; s += nw) gather(s);
  int slot = 0, gw = look % nw;          // gw gathers stage s + look
  uint32_t phase = 0;
  const float2* Sb = sbuf + fr;
  float yr[FPT][2 * NP], yi[FPT][2 * NP];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int x = 0; x < 2 * NP; ++x) yr[i][x] = yi[i][x] = 0.f;
  for (int s = 0; s < nst; ++s) {
    if (warp == gw && s + look < nst) gather(s + look);
    if (++gw == nw) gw = 0;
    bar_wait(sbar + s, 0);
    bar_wait(full + slot, phase);
    const int r0 = s * MC + k * RG, rows = min(RG, M - r0);
    const float2* Ps = ring + (size_t)slot * MC * DC + k * RG * DC;
    const float2* Ss = Sb + r0 * BT;
    if (rows == RG) {
#pragma unroll
      for (int mm = 0; mm < RG; ++mm)
        fma_row<FPT, NP>(Ss + mm * BT, Ps + mm * DC, po, yr, yi);
    } else {
      for (int mm = 0; mm < rows; ++mm)
        fma_row<FPT, NP>(Ss + mm * BT, Ps + mm * DC, po, yr, yi);
    }
    __syncwarp();
    if (lane == 0) {
      bar_arrive(empty + slot);
      if (atomicAdd(ticket + slot, 1) == nw - 1) {
        ticket[slot] = 0;
        bar_wait(empty + slot, phase);
        if (s + ns < nst) issue(s + ns, slot);
      }
    }
    if (++slot == ns) {
      slot = 0;
      phase ^= 1;
    }
  }
  float2* yb = ybuf + k * YS;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int d = d0 + 2 * T::DL * q;
    if (d < DC) {
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        yb[(fr + i) * DC + d] = make_float2(yr[i][2 * q], yi[i][2 * q]);
        yb[(fr + i) * DC + d + 1] =
            make_float2(yr[i][2 * q + 1], yi[i][2 * q + 1]);
      }
    }
  }
  __syncthreads();
  // this thread's share of the bin's Y, summed over the groups in order,
  // squared and weighted
  const float wf = w ? w[f] : 1.f;
  float* o = out + (size_t)f * B * D;
  for (int e = tid; e < YS; e += nct) {
    const int bg = z * BT + e / DC, dg = c * DC + e % DC;
    if (bg < B && dg < D) {
      float yre = 0.f, yim = 0.f;
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        const float2 v = ybuf[r * YS + e];
        yre += v.x;
        yim += v.y;
      }
      o[(size_t)bg * D + dg] = wf * fmaf(yre, yre, yim * yim);
    }
  }
}

// out[i] = sum over the F bins' maps: 32 outputs a block, its 8 warps each
// summing every 8th bin, then the 8 sums in warp order
__global__ void __launch_bounds__(256)
bartlett_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int n, int F) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int f = s; f < F; f += 8) v += part[(size_t)f * n + i];
  }
  red[s][lane] = v;
  __syncthreads();
  if (s == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += red[r][lane];
    out[i] = t;
  }
}

template <int BT>
cudaError_t launch(const float2* X, const float2* Pt, const int* adaptive,
                   const int* bins, const float* w, float* part, int B,
                   int C, int NF, int F, int M, int D, int DC, int NC,
                   int smem_max, cudaStream_t stream) {
  int ns = MAX_STAGES;                   // as deep a ring as fits
  while (ns >= 2 && smem_bytes(BT, DC, M, ns) > (size_t)smem_max) --ns;
  if (ns < 2) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(BT, DC, M, ns);
  cudaError_t e = cudaFuncSetAttribute(
      bartlett_power_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(F, NC, (B + BT - 1) / BT);
  const int threads = 32 * KS * ((DC + WD - 1) / WD);
  bartlett_power_kernel<BT><<<grid, threads, smem, stream>>>(
      X, Pt, adaptive, bins, w, part, B, C, NF, F, M, D, DC, ns);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The maps (B, D) into out, through part (F, B, D), the bins' maps.
// bt is the frame tile (1, 2, 4, 8 or 16).  Returns a cudaError_t.
int zrt_bartlett_power(const void* X, const void* Pt, const int* adaptive,
                       const int* bins, const float* w, float* part,
                       float* out, int B, int C, int NF, int F, int M, int D,
                       int DC, int NC, int bt, cudaStream_t stream) {
  if (F < 1 || M < 1 || M > NQ * MC || DC % 16 != 0 || DC > 3 * WD)
    return (int)cudaErrorInvalidValue;
  int dev, smem_max;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const float2* x = static_cast<const float2*>(X);
  const float2* p = static_cast<const float2*>(Pt);
  switch (bt) {
#define ZRT_BT(n)                                                           \
  case n:                                                                   \
    e = launch<n>(x, p, adaptive, bins, w, part, B, C, NF, F, M, D, DC, NC, \
                  smem_max, stream);                                        \
    break;
    ZRT_BT(1) ZRT_BT(2) ZRT_BT(4) ZRT_BT(8) ZRT_BT(16)
#undef ZRT_BT
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const int n = B * D;
  bartlett_sum_kernel<<<(n + 31) / 32, 256, 0, stream>>>(part, out, n, F);
  return (int)cudaGetLastError();
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
