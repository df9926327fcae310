// The product core shared by the two equiv kernels (equiv_power.cu, K1;
// equiv_power_fd.cu, K5): the per-bin product of the spectra rows with the
// one response plane, the once-a-bin reduction over warps, the Parseval
// sum and the tail/head fold, and the finish with the sparse head
// corrections.
//
// Inputs, as ops/equiv_kernel.py lays them out:
//   S   (F, BP, KS)      spectra rows [sr | si], each half padded to MP =
//                        KP/2, rows padded to KS = KP + 16 bytes
//   H1  (DP/TD, F, KP, TD)  sqrt(cf) * [Hr | -Hi], direction-tile-major:
//                        one block's tile of one bin is one contiguous run
//                        of KP * TD elements, fetched by one bulk copy
//   ib1/ib2 (F, TtA)     tail/head inverse-DFT bases / sqrt(cf), rows
//                        padded to TtA = Tt rounded up to 4 (bulk copies)
//   wc_ptr (DP*Tc + 1), wc_idx, wc_val   the nonzero head-correction
//                        weights, CSR over rows d*Tc + c
//
// Br = [sr | si] . H1 and Bi = [si | -sr] . H1: one plane serves both, the
// second row set is the first with its halves swapped and one negated.  The
// FP32 product takes k and k + MP together (four FMAs from two spectra and
// two H values); the bf16 product gives each warp a K slice inside one
// half, so the swap is a fixed offset and the sign one bit flip per warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace zrt_equiv {

// Threads per block (NT below, a template parameter of the core): 8
// warps, or 16 where one block must fill an SM (K1 at frame tile 16, K5's
// chunk kernel from tile 8 up) and each bin's latency needs more warps to
// hide.  Where two blocks fit an SM, two blocks of 8 warps are faster.
template <int BT>
__host__ __device__ constexpr int k1_threads() {
  return BT >= 16 ? 512 : 256;
}
template <int BT>
__host__ __device__ constexpr int fd_threads() {
  return BT >= 8 ? 512 : 256;
}
constexpr int FCB = 4;           // bins folded per tail/head pass
constexpr int MAX_STAGES = 8;

// Per plane type: directions per tile, the row padding of S (16 bytes),
// and whether the product runs on tensor cores.
template <typename T>
struct Plane;
template <>
struct Plane<float> {
  static constexpr int TD = 8, KPAD = 4;
  static constexpr bool mma = false;
};
template <>
struct Plane<__nv_bfloat16> {
  static constexpr int TD = 16, KPAD = 8;
  static constexpr bool mma = true;
};

// Warps that split the N side of the bf16 product (2*BT rows in tiles of
// 8); the rest split K.  The FP32 product splits K over all warps.
template <typename T, int BT>
__host__ __device__ constexpr int n_split() {
  return Plane<T>::mma ? (2 * BT + 7) / 8 : 1;
}
template <typename T, int BT, int NT>
__host__ __device__ constexpr int k_split() {
  return NT / 32 / n_split<T, BT>();
}

__host__ __device__ inline size_t round128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared memory of a block, in bytes from the base: the mbarriers (ring
// stages 0..7, the two base buffers IB_BAR, IB_BAR + 1, K5's S chunk
// S_BAR), then area0 (K1: the ring of NS (S rows, H tile) stages, later
// the sj rows; K5: its S chunk of fc bins, then the ring of NS H tiles),
// the tail/head accumulators th [Tt][BT*TD], the warp partials red
// [2][KSPLIT][2BT][TD], the reduced Br/Bi rows brbi [2][FCB][2BT][TD] and
// the bases of two fold chunks ibs [2][2][FCB][TtA] (TtA = Tt rounded up
// to 4, the bases' row length).
constexpr int IB_BAR = MAX_STAGES, S_BAR = MAX_STAGES + 2;

__host__ __device__ inline int tt_align(int Tt) { return (Tt + 3) & ~3; }

struct Layout {
  size_t area0, th, red, brbi, ibs, total;
};

template <typename T, int BT, int NT>
__host__ __device__ inline Layout layout(int Tt, int KP, int JM, int NS,
                                         int fc) {
  constexpr int TD = Plane<T>::TD;
  const size_t KS = (size_t)KP + Plane<T>::KPAD;
  const size_t s_bin = (size_t)BT * KS * sizeof(T);
  const size_t h_tile = (size_t)KP * TD * sizeof(T);
  size_t a0;
  if (fc == 0) {
    a0 = NS * (s_bin + h_tile);
    const size_t sj = (size_t)BT * JM * sizeof(float);
    if (sj > a0) a0 = sj;
  } else {
    a0 = fc * s_bin + NS * h_tile;
  }
  Layout L;
  L.area0 = 128;
  L.th = L.area0 + round128(a0);
  L.red = L.th + round128((size_t)Tt * BT * TD * sizeof(float));
  L.brbi = L.red + round128(2 * (size_t)k_split<T, BT, NT>() * 2 * BT * TD *
                            sizeof(float));
  L.ibs = L.brbi + round128(2 * (size_t)FCB * 2 * BT * TD * sizeof(float));
  L.total = L.ibs + 2 * 2 * (size_t)FCB * tt_align(Tt) * sizeof(float);
  return L;
}

// ---- mbarriers and bulk copies (sm_90) -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals (and the
// bytes its bulk copies expect).
__device__ __forceinline__ void bar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy global -> shared that completes on `bar`; dst, src and
// bytes are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before its later bulk copies into it (a ring stage is refilled after
// every thread has read it).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the per-bin product ---------------------------------------------------

// Sums the first N values of v over the two lanes that differ in `mask`,
// each lane keeping one half (the upper half where `upper`): afterwards
// v[0, N/2) hold the sums of that half.  Fewer shuffles than a full
// butterfly, and every sum is (own + partner's) in either lane.
template <int N>
__device__ __forceinline__ void reduce_half(float* v, int mask, bool upper) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// FP32 FMAs on the CUDA cores, in pairs: with k < MP and its partner
// k + MP (Hr and -Hi rows of H1),
//   Br += sr_k Hr_k + si_k (-Hi_k)      Bi += si_k Hr_k - sr_k (-Hi_k)
// so two spectra values and two H values feed four FMAs per (frame,
// direction).  Warp w takes the pairs [w*PW, (w+1)*PW), PW = MP / warps.
// A lane owns 4 directions (dq) x FB frames x (Br, Bi) over the 4-wide pair
// chunks kq, kq + NQ, ... (float4 loads; the lanes of a load phase hit
// distinct banks, rows padded by 16 bytes).  BT >= 4: FB = BT/4 frames q,
// q + 4, ... and NQ = 4 K lanes; BT < 4: all frames and NQ = 16.  The K
// lanes' sums are then reduced by halving shuffles, and each lane writes
// its share of the warp's partials to red [KSPLIT][2BT][TD].
template <int BT, int NT>
__device__ __forceinline__ void product(const float* __restrict__ Ss,
                                        const float* __restrict__ Hs,
                                        int KP, float* __restrict__ red) {
  constexpr int TD = 8, NR = 2 * BT * TD;
  constexpr bool WIDE = BT >= 4;
  constexpr int FB = WIDE ? BT / 4 : BT, NQ = WIDE ? 4 : 16;
  constexpr int N = FB * 8;             // (frame, Br/Bi, direction) sums
  const int KS = KP + Plane<float>::KPAD;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dq = lane & 1;
  const int fq = WIDE ? (lane >> 1) & 3 : 0;
  const int kq = WIDE ? lane >> 3 : lane >> 1;
  const int MP = KP >> 1, PW = MP / (NT / 32), k0 = w * PW;
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
  for (int c = kq; 4 * c < PW; c += NQ) {
    const int k = k0 + 4 * c;
    float4 hr[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hr[e] = *reinterpret_cast<const float4*>(Hs + (size_t)(k + e) * TD +
                                               4 * dq);
      hi[e] = *reinterpret_cast<const float4*>(
          Hs + (size_t)(k + MP + e) * TD + 4 * dq);
    }
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      const float* row = Ss + (size_t)(WIDE ? fq + 4 * i : i) * KS + k;
      const float4 r4 = *reinterpret_cast<const float4*>(row);
      const float4 i4 = *reinterpret_cast<const float4*>(row + MP);
      const float sr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float si[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a[4] = {hr[e].x, hr[e].y, hr[e].z, hr[e].w};
        const float m[4] = {hi[e].x, hi[e].y, hi[e].z, hi[e].w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float& br = v[i * 8 + x];
          float& bi = v[i * 8 + 4 + x];
          br = fmaf(si[e], m[x], fmaf(sr[e], a[x], br));
          bi = fmaf(-sr[e], m[x], fmaf(si[e], a[x], bi));
        }
      }
    }
  }
  // the K lanes differ in lane bits 3-4 (WIDE) or 1-4
  int off = 0, live = N;
  bool writer = true;
  if constexpr (WIDE) {
    reduce_half<N>(v, 8, lane & 8);
    off += (lane & 8) ? N / 2 : 0;
    reduce_half<N / 2>(v, 16, lane & 16);
    off += (lane & 16) ? N / 4 : 0;
    live = N / 4;
  } else {
    reduce_half<N>(v, 2, lane & 2);
    off += (lane & 2) ? N / 2 : 0;
    reduce_half<N / 2>(v, 4, lane & 4);
    off += (lane & 4) ? N / 4 : 0;
    reduce_half<N / 4>(v, 8, lane & 8);
    off += (lane & 8) ? N / 8 : 0;
    if constexpr (N >= 16) {
      reduce_half<N / 8>(v, 16, lane & 16);
      off += (lane & 16) ? N / 16 : 0;
      live = N / 16;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
      writer = !(lane & 16);
      live = 1;
    }
  }
  if (writer) {
    float* rw = red + (size_t)w * NR;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      if (i < live) {
        const int idx = off + i;
        const int fi = idx >> 3, bi_row = (idx >> 2) & 1, x = idx & 3;
        const int b = WIDE ? fq + 4 * fi : fi;
        rw[(bi_row ? BT + b : b) * TD + 4 * dq + x] = v[i];
      }
    }
  }
}

// bf16 operands on the tensor cores, FP32 accumulation:
// mma.sync.m16n8k16, the TD = 16 directions on M (A = H1 tile, read
// transposed from its k-major rows by ldmatrix.trans), the 2*BT spectra
// rows on N (B, 32-bit loads along K; one frame pads to n = 8).  Warp w
// takes N tile w % NSPLIT and K slice w / NSPLIT.  A product of two bf16
// values is exact in FP32, so this is the plain version's arithmetic in
// another order.
template <int BT, int NT>
__device__ __forceinline__ void product(const __nv_bfloat16* __restrict__ Ss,
                                        const __nv_bfloat16* __restrict__ Hs,
                                        int KP, float* __restrict__ red) {
  constexpr int TD = 16, NR = 2 * BT * TD;
  constexpr int NSPL = n_split<__nv_bfloat16, BT>();
  constexpr int KSPL = k_split<__nv_bfloat16, BT, NT>();
  const int KS = KP + Plane<__nv_bfloat16>::KPAD;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = w % NSPL, ks = w / NSPL;
  const int g = lane >> 2, tig = lane & 3;
  const int MP = KP >> 1, KW = KP / KSPL, k0 = ks * KW;
  const bool second = k0 >= MP;
  const int kp0 = second ? k0 - MP : k0 + MP;
  // this lane's B row n = nt*8 + g: a Br row, a Bi row (swapped halves,
  // negated on the second half) or padding
  const int n = nt * 8 + g;
  const bool valid = n < 2 * BT;
  const bool bi_row = n >= BT;
  const uint32_t neg = (bi_row && second) ? 0x80008000u : 0u;
  const __nv_bfloat16* srow =
      Ss + (size_t)(valid ? (bi_row ? n - BT : n) : 0) * KS +
      (bi_row ? kp0 : k0) + tig * 2;
  // ldmatrix.x4.trans: matrices (k 0-7, d 0-7), (k 0-7, d 8-15),
  // (k 8-15, d 0-7), (k 8-15, d 8-15) give a0a1, a2a3, a4a5, a6a7
  const __nv_bfloat16* hrow = Hs + (size_t)(k0 + (lane & 7) +
                                            ((lane >> 4) << 3)) * TD +
                              ((lane >> 3) & 1) * 8;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll 4
  for (int k = 0; k < KW; k += 16) {
    uint32_t a0, a1, a2, a3;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
        : "r"(smem_addr(hrow + (size_t)k * TD)));
    uint32_t b0 = 0u, b1 = 0u;
    if (valid) {
      b0 = *reinterpret_cast<const uint32_t*>(srow + k) ^ neg;
      b1 = *reinterpret_cast<const uint32_t*>(srow + k + 8) ^ neg;
    }
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  // C: (d = g, n = 2*tig, 2*tig + 1) and (d = g + 8, the same n)
  float* rw = red + (size_t)ks * NR;
  const int n0 = nt * 8 + 2 * tig;
  if (n0 < 2 * BT) {
    rw[n0 * TD + g] = c0;
    rw[n0 * TD + g + 8] = c2;
  }
  if (n0 + 1 < 2 * BT) {
    rw[(n0 + 1) * TD + g] = c1;
    rw[(n0 + 1) * TD + g + 8] = c3;
  }
}

// The warps' partials of one bin summed in a fixed order into its Br/Bi
// rows: dst [2BT][TD].
template <typename T, int BT, int NT>
__device__ __forceinline__ void reduce(const float* __restrict__ red,
                                       float* __restrict__ dst) {
  constexpr int NR = 2 * BT * Plane<T>::TD, KSPL = k_split<T, BT, NT>();
  for (int i = threadIdx.x; i < NR; i += NT) {
    float s = red[i];
#pragma unroll
    for (int q = 1; q < KSPL; ++q) s += red[q * NR + i];
    dst[i] = s;
  }
}

// Fetches the bases of one fold chunk (bins f .. f + nb - 1 of ib1 and
// ib2, rows of TtA floats) into dst [2][FCB][TtA] with two bulk copies.
__device__ __forceinline__ void issue_bases(float* dst,
                                            const float* __restrict__ ib1,
                                            const float* __restrict__ ib2,
                                            int f, int nb, int TtA,
                                            uint64_t* bar) {
  const uint32_t bytes = (uint32_t)(nb * TtA * sizeof(float));
  bar_expect(bar, 2 * bytes);
  bulk_load(dst, ib1 + (size_t)f * TtA, bytes, bar);
  bulk_load(dst + FCB * TtA, ib2 + (size_t)f * TtA, bytes, bar);
}

// Folds nb (<= FCB) bins' Br/Bi rows (src [nb][2BT][TD]) into the
// Parseval sum pw (held by the thread of output tid, tid < NO) and the
// tail/head samples th [Tt][NO], with the chunk's bases ibs [2][FCB][TtA]
// in shared memory.  A thread owns OB neighbouring outputs of every
// G-th sample t for the whole launch, so each base value it loads feeds
// 2*OB FMAs.  FP32 in every mode, bins summed in order.
template <typename T, int BT, int NT>
__device__ __forceinline__ void fold(float* __restrict__ th,
                                     const float* __restrict__ src, int nb,
                                     const float* __restrict__ ibs, int TtA,
                                     int Tt, float& pw) {
  constexpr int TD = Plane<T>::TD, NO = BT * TD, NR = 2 * NO;
  constexpr int OB = NO >= 128 ? 4 : (NO >= 64 ? 2 : 1);
  constexpr int OG = NO / OB, G = NT / OG;
  const int tid = threadIdx.x;
  if (tid < NO) {
    for (int fl = 0; fl < nb; ++fl) {
      const float br = src[fl * NR + tid], bi = src[fl * NR + NO + tid];
      pw = fmaf(br, br, fmaf(bi, bi, pw));
    }
  }
  const int o0 = (tid % OG) * OB, g = tid / OG;
  float br[FCB][OB], bi[FCB][OB];
#pragma unroll
  for (int fl = 0; fl < FCB; ++fl) {
#pragma unroll
    for (int u = 0; u < OB; ++u) {
      br[fl][u] = fl < nb ? src[fl * NR + o0 + u] : 0.f;
      bi[fl][u] = fl < nb ? src[fl * NR + NO + o0 + u] : 0.f;
    }
  }
  const float* i1 = ibs;
  const float* i2 = ibs + FCB * TtA;
#pragma unroll 2
  for (int t = g; t < Tt; t += G) {
    float acc[OB];
#pragma unroll
    for (int u = 0; u < OB; ++u) acc[u] = th[t * NO + o0 + u];
#pragma unroll
    for (int fl = 0; fl < FCB; ++fl) {
      if (fl < nb) {
        const float a = i1[fl * TtA + t], b = i2[fl * TtA + t];
#pragma unroll
        for (int u = 0; u < OB; ++u)
          acc[u] = fmaf(a, br[fl][u], fmaf(b, bi[fl][u], acc[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < OB; ++u) th[t * NO + o0 + u] = acc[u];
  }
}

// The finish of one (frame tile, direction tile): the head corrections
// v = sj . Wc from the sparse list (each entry read once for all BT frames,
// nothing multiplied by zero) replace th's head rows by v^2 - 2 TH v; then
// out = (pw - sum of the tail squares + those terms) * inv.  srows
// [BT][JM] holds the tile's sj rows; scratch [G][NO] floats.  Both must be
// in shared memory and visible (a barrier before the call); pw is held by
// thread tid < NO.
template <typename T, int BT, int NT>
__device__ __forceinline__ void finish(
    float* __restrict__ th, const float* __restrict__ srows, int JM,
    float* __restrict__ scratch, float pw, const int* __restrict__ wc_ptr,
    const int* __restrict__ wc_idx, const float* __restrict__ wc_val,
    int d0, int n_tail, int Tc, float inv, float* __restrict__ out, int b0,
    int DP) {
  constexpr int TD = Plane<T>::TD, NO = BT * TD, G = NT / NO;
  const int tid = threadIdx.x;
  for (int i = tid; i < Tc * TD; i += NT) {
    const int c = i / TD, dx = i % TD;
    const int r = (d0 + dx) * Tc + c;
    const int e1 = __ldg(wc_ptr + r + 1);
    float v[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) v[b] = 0.f;
    int e = __ldg(wc_ptr + r);
    // eight entries' loads in flight at a time: a row may hold hundreds
    for (; e + 8 <= e1; e += 8) {
      int j[8];
      float wv[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        j[q] = __ldg(wc_idx + e + q);
        wv[q] = __ldg(wc_val + e + q);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
#pragma unroll
        for (int b = 0; b < BT; ++b)
          v[b] = fmaf(srows[b * JM + j[q]], wv[q], v[b]);
      }
    }
    for (; e < e1; ++e) {
      const int j = __ldg(wc_idx + e);
      const float wv = __ldg(wc_val + e);
#pragma unroll
      for (int b = 0; b < BT; ++b) v[b] = fmaf(srows[b * JM + j], wv, v[b]);
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float* h = th + (size_t)(n_tail + c) * NO + b * TD + dx;
      *h = v[b] * v[b] - 2.f * *h * v[b];
    }
  }
  __syncthreads();
  const int o = tid % NO, g = tid / NO, Tt = n_tail + Tc;
  float acc = 0.f;
  for (int t = g; t < Tt; t += G) {
    const float y = th[t * NO + o];
    acc = t < n_tail ? fmaf(-y, y, acc) : acc + y;
  }
  scratch[g * NO + o] = acc;
  __syncthreads();
  if (tid < NO) {
    float total = pw;
    for (int q = 0; q < G; ++q) total += scratch[q * NO + tid];
    out[(size_t)(b0 + tid / TD) * DP + d0 + tid % TD] = total * inv;
  }
}

}  // namespace zrt_equiv
