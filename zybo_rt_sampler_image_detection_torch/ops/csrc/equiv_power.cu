// Fused exact frequency-domain steered power (the "equiv" kernel) for Hopper.
//
// Replaces the Pallas TPU kernel
// zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py::_equiv_power_kernel.
// It computes the same function, not the same blocks.  For frame b and
// direction d, with spectra rows s = S[f, b, :] = [sr | si]:
//
//   Br[f,b,d] = [sr | si] . H1[f,:,d]    Bi[f,b,d] = [si | -sr] . H1[f,:,d]
//   pow       = sum_f Br^2 + Bi^2                    (sqrt(cf) folded in H1)
//   TH[t,b,d] = sum_f ib1[f,t] Br + ib2[f,t] Bi      (t < n_tail + Tc)
//   v[c,b,d]  = sum over the nonzero Wc[j, d, c, m] of sj[b, j*M + m] * Wc
//   out[b,d]  = (pow - sum_{p<n_tail} TH[p]^2
//                + sum_{c<Tc} (v_c^2 - 2 TH[n_tail+c] v_c)) * inv
//
// What bounds it on an H100: at the reference shape (K = 2M = 512, D =
// 1824, F = 154-158) the one response plane H1 is 0.58 GB in FP32 (0.29 GB
// in bf16).  At the live batch of one frame each element is used for two
// products, so reading H1 from HBM bounds the kernel (>= 0.17 ms at 3.35
// TB/s).  At 16 frames the FP32 FMAs of the product (about 9 GFLOP) come
// close to the bytes; in bf16 the product runs on the tensor cores and the
// bytes bound it again.
//
// Two routes.  The fused kernel just below keeps Br/Bi on chip in one
// launch; bf16 and the smaller FP32 batches run it.  f32 and high from 8
// padded frames run two kernels further down (the product pass, then the
// fold and finish), because there the fused form's per-output tail/head
// sums confine its blocks (see there).
//
// The fused kernel's design:
// * One plane.  Bi uses H1 too, with the spectra row's halves swapped and
//   one negated (equiv_core.cuh), so H is read once per bin, not twice.
// * H leaves HBM once per call.  A block owns (BT frames x TD directions)
//   and loops over all F bins (the TPU's sequential f axis; no atomics,
//   deterministic).  At the main path's batches (1 and 16) the frame tile
//   covers the batch; at larger batches the grid runs the frame tiles
//   fastest, so the blocks that share a direction tile run together and
//   later tiles read H from L2.
// * Loads in flight.  H1 is laid out direction-tile-major, so a block's
//   tile of one bin is one contiguous run; one thread fetches it and the
//   frames' spectra rows with two bulk copies (cp.async.bulk, completing
//   on an mbarrier) into a ring of NS stages, and the tail/head bases of
//   each 4-bin fold the same way.  The host sizes NS and the frame tile
//   from the runtime's occupancy (zrt_equiv_power_blocks_per_sm), so that
//   the grid fills the SMs with bytes in flight.
// * One block barrier a bin.  Each warp multiplies its K slice for every
//   output of the block; the warps' partials are summed once per bin
//   (double-buffered, so one barrier orders them), and the tail/head fold
//   runs once per 4 bins from the reduced Br/Bi rows.  Blocks of 8 warps;
//   16 at frame tile 16, where one block fills an SM.
// * The ~100 tail/head accumulators per output live in shared memory (Tt x
//   BT*TD floats), each owned by one thread for the whole launch.
// * Head corrections from a sparse list: per (direction, correction) the
//   nonzero weights of Wc (2% of the dense one-hot layout for lerp, 4% for
//   hybrid), each read once per frame tile, eight loads in flight; nothing
//   is multiplied by zero.
// * Precision: f32 and high run FP32 FMAs on the CUDA cores (TD = 8); bf16
//   runs mma.sync.m16n8k16 on the tensor cores with FP32 accumulation
//   (TD = 16, directions on M, spectra rows on N).  The tail/head term and
//   the corrections are FP32 in every mode.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns cudaGetLastError().

#include "equiv_core.cuh"

namespace {

using namespace zrt_equiv;

template <typename T, int BT>
__global__ void __launch_bounds__(k1_threads<BT>())
equiv_power_kernel(const T* __restrict__ S, const T* __restrict__ H1,
                   const float* __restrict__ ib1,
                   const float* __restrict__ ib2,
                   const float* __restrict__ sj,
                   const int* __restrict__ wc_ptr,
                   const int* __restrict__ wc_idx,
                   const float* __restrict__ wc_val, float* __restrict__ out,
                   int F, int BP, int KP, int DP, int TtA, int n_tail, int Tc,
                   int JM, int NS, float inv) {
  constexpr int TD = Plane<T>::TD, NR = 2 * BT * TD, NT = k1_threads<BT>();
  constexpr int KSPL = k_split<T, BT, NT>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tt = n_tail + Tc;
  const Layout L = layout<T, BT, NT>(Tt, KP, JM, NS, 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + L.area0;
  float* th = reinterpret_cast<float*>(smem + L.th);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* brbi = reinterpret_cast<float*>(smem + L.brbi);
  float* ibs = reinterpret_cast<float*>(smem + L.ibs);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT, tile = blockIdx.y, d0 = tile * TD;
  const int KS = KP + Plane<T>::KPAD;
  const uint32_t s_bytes = (uint32_t)(BT * KS * sizeof(T));
  const uint32_t h_bytes = (uint32_t)(KP * TD * sizeof(T));
  const size_t stage = s_bytes + h_bytes;
  const T* Sg = S + (size_t)b0 * KS;
  const T* Hg = H1 + (size_t)tile * F * KP * TD;
  const int n_chunks = (F + FCB - 1) / FCB;   // fold chunks of FCB bins

  // bin f into ring stage f % NS: the frames' rows, then the H tile
  auto issue = [&](int f) {
    uint64_t* bar = bars + f % NS;
    unsigned char* dst = ring + (size_t)(f % NS) * stage;
    bar_expect(bar, s_bytes + h_bytes);
    bulk_load(dst, Sg + (size_t)f * BP * KS, s_bytes, bar);
    bulk_load(dst + s_bytes, Hg + (size_t)f * KP * TD, h_bytes, bar);
  };
  // the bases of fold chunk c into buffer c % 2
  auto issue_ib = [&](int c) {
    const int f = c * FCB, nb = F - f < FCB ? F - f : FCB;
    issue_bases(ibs + (size_t)(c & 1) * 2 * FCB * TtA, ib1, ib2, f, nb, TtA,
                bars + IB_BAR + (c & 1));
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) bar_init(bars + s);
    bar_init(bars + IB_BAR);
    bar_init(bars + IB_BAR + 1);
    bar_init_fence();
  }
  for (int i = tid; i < Tt * BT * TD; i += NT) th[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    for (int f = 0; f < NS && f < F; ++f) issue(f);
    for (int c = 0; c < 2 && c < n_chunks; ++c) issue_ib(c);
  }

  float pw = 0.f;              // Parseval sum, held by the thread tid < NO
  int folds = 0, fb = 0;       // folds done; first bin of the open fold
  for (int f = 0; f < F; ++f) {
    const int s = f % NS;
    bar_wait(bars + s, (uint32_t)((f / NS) & 1));
    const T* Ss = reinterpret_cast<const T*>(ring + (size_t)s * stage);
    float* rp = red + (size_t)(f & 1) * KSPL * NR;
    product<BT, NT>(Ss, Ss + s_bytes / sizeof(T), KP, rp);
    __syncthreads();
    if (tid == 0) {
      // every thread has read stage s, and (at a chunk's first bin) the
      // bases buffer of the chunk before last: refill them
      fence_async_shared();
      if (f + NS < F) issue(f + NS);
      if (f == fb && folds >= 1 && folds + 1 < n_chunks) issue_ib(folds + 1);
    }
    float* dst = brbi + (size_t)(folds & 1) * FCB * NR;
    reduce<T, BT, NT>(rp, dst + (size_t)(f - fb) * NR);
    if (f - fb + 1 == FCB || f == F - 1) {
      __syncthreads();
      bar_wait(bars + IB_BAR + (folds & 1), (uint32_t)((folds >> 1) & 1));
      fold<T, BT, NT>(th, dst, f - fb + 1,
                  ibs + (size_t)(folds & 1) * 2 * FCB * TtA, TtA, Tt, pw);
      ++folds;
      fb = f + 1;
    }
  }

  // the epilogue: sj rows into the ring's space, then the finish
  __syncthreads();
  float* srows = reinterpret_cast<float*>(ring);
  for (int i = tid; i < BT * JM; i += NT) srows[i] = sj[(size_t)b0 * JM + i];
  __syncthreads();
  finish<T, BT, NT>(th, srows, JM, red, pw, wc_ptr, wc_idx, wc_val, d0,
                    n_tail, Tc, inv, out, b0, DP);
}

// ---- the FP32 route in two passes ----------------------------------------
//
// Both replace the same TPU kernel as the fused one above
// (zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py:74,
// _equiv_power_kernel).  The fused kernel confines a block to BT x TD
// outputs, because each output keeps Tt tail/head sums in shared memory;
// every bin's product is then split over all warps, reduced and folded
// behind block barriers.  On the H100 keeping Br/Bi on chip costs more than
// it saves: at 16 frames they are 6% (192 channels) to 25% (64 channels) of
// the plane's bytes.  So f32/high runs two kernels on the caller's stream
// instead (the host routes fewer than 8 padded frames to the fused kernel,
// faster there at 192 channels):
//
// 1. equiv_product_kernel: P[f] = [[sr | si]; [si | -sr]] . H1[f] for the
//    2BP spectra rows (the second row set derived, never stored).  What
//    bounds it: the plane's bytes (0.58 GB at the reference shape) and, at
//    16 frames, its FP32 FMAs (9.2 GFLOP) about as much.  The design: a
//    block owns one bin, FB frames and 8 * nc direction tiles; each thread
//    keeps RF frames x CD directions of Br and Bi in registers over the
//    whole K loop (no K split, no reduction, no block barrier).  One
//    producer warp keeps a ring of two stages full with bulk copies
//    (full/empty mbarriers): per stage the frames' spectra for 16 k pairs
//    (64-byte copies) and each tile's slices of rows k and k + MP
//    (512-byte copies; 256-byte ones stream at two thirds the rate).  Small
//    blocks (2-4 consumer warps, 55-72 KB) put 3-4 on an SM, which beat a
//    deeper ring.  The grid is (frame groups x direction groups x bins):
//    thousands of short blocks, no wave tail.
// 2. equiv_fold_kernel: per output, the Parseval sum and the tail/head
//    samples TH = sum_f ib1 Br + ib2 Bi from P, bins in order (the product
//    writes P in the order the fold reads it, so a block's 8 bins are one
//    bulk copy, four stages in flight), then the finish (tails subtracted,
//    the head corrections).  What bounds it: its FMAs, 2 * 2BP * Tt * DP *
//    F, and the latency of the corrections.  A warp owns 8 samples t of 32
//    directions x OQ frames; the block's warps cover every t and sum their
//    terms in a fixed order.  The corrections walk each direction's run of
//    the sparse list 32 entries at a time, a warp to a direction, because
//    the rows' lengths are skewed (lerp: M entries a direction, at some
//    directions all in one row), with a segmented sum over the lanes in a
//    fixed order: no atomics, deterministic.

constexpr int SPLIT_KC = 16;         // k pairs of one ring stage
constexpr int SPLIT_MAX_WARPS = 4;   // consumer warps of a product block
constexpr int FOLD_TQ = 8;           // tail/head samples a fold thread owns
constexpr int FOLD_MAX_WARPS = 16;   // so Tt <= 128
constexpr int FOLD_FC = 8;           // bins of one fold stage
constexpr int FOLD_STAGES = 4;       // fold stages in flight

// floats of one direction tile's slice in a ring stage: the KC rows of the
// first half, the KC rows of the second, 8 floats of padding, so that the
// 8 tiles a warp reads start on 4 different bank groups
constexpr int SPLIT_TS = 16 * SPLIT_KC + 8;

// a ring stage of a product block: the fb frames' spectra [fb][sr | si][KC]
// for the stage's k pairs, then 8 * nc tile slices
__host__ __device__ inline size_t split_stage(int fb, int nc) {
  return (size_t)fb * 2 * SPLIT_KC + (size_t)nc * 8 * SPLIT_TS;
}
// shared memory of a product block: mbarriers (full[8], empty[8]), then
// ns ring stages
__host__ __device__ inline size_t split_smem(int fb, int nc, int ns) {
  return 128 + (size_t)ns * split_stage(fb, nc) * 4;
}

// P, the product pass's output, in the order the fold reads it: (DP/32
// direction blocks, BP/oq frame groups, F bins, Br/Bi, oq frames, 32
// directions), so that the FOLD_FC bins of a fold block are one run.
__host__ __device__ inline size_t split_p_index(int b, int h, int d, int f,
                                                int F, int BP, int oq) {
  return ((((size_t)(d >> 5) * (BP / oq) + b / oq) * F + f) * 2 + h) *
             oq * 32 +
         (size_t)(b % oq) * 32 + (d & 31);
}

// A thread of the product pass owns RF frames x CD directions: from two
// frames up, the warp's lanes are 2 frame halves x 16 direction quads, so
// a load of the H slice feeds 8 x RF FMAs; one frame takes 32 direction
// pairs.  A warp covers 8 tiles (64 directions) either way.
template <int FB>
struct SplitTile {
  static constexpr int CD = FB >= 2 ? 4 : 2, RF = FB >= 2 ? FB / 2 : 1;
};

template <int FB>
__global__ void __launch_bounds__(32 * (SPLIT_MAX_WARPS + 1), 3)
equiv_product_kernel(const float* __restrict__ S,
                     const float* __restrict__ H1, float* __restrict__ P,
                     int F, int BP, int KP, int DP, int ns, int oq) {
  constexpr int CD = SplitTile<FB>::CD, RF = SplitTile<FB>::RF;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nc = (int)(blockDim.x >> 5) - 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  float* ring = reinterpret_cast<float*>(smem + 128);
  const int KS = KP + Plane<float>::KPAD, MP = KP >> 1;
  const int b0 = blockIdx.x * FB, f = blockIdx.z;
  const int tile0 = blockIdx.y * nc * 8;
  const int nt = min(nc * 8, DP / 8 - tile0);    // tiles of this block
  const int nst = MP / SPLIT_KC;                 // ring stages a bin
  const size_t stage = split_stage(FB, nc);
  constexpr int SF = FB * 2 * SPLIT_KC;          // floats of the spectra
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      bar_init(full + s);
      bar_init(empty + s, nc * 32);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (w == nc) {
    // the producer warp keeps the ring full: per stage the frames' spectra
    // (k pairs of both halves) and the tiles' H slices, 64 and 512 bytes
    const uint32_t sb = SPLIT_KC * sizeof(float), hb = 8 * sb;
    const float* Sf = S + ((size_t)f * BP + b0) * KS;
    const float* Hf = H1 + (size_t)f * KP * 8;
    for (int st = 0; st < nst; ++st) {
      const int slot = st % ns;
      // every consumer thread has released the stage's last use
      if (st >= ns) bar_wait(empty + slot, (uint32_t)((st / ns - 1) & 1));
      if (lane == 0) bar_expect(full + slot, 2u * (FB * sb + nt * hb));
      __syncwarp();
      fence_async_shared();
      float* dst = ring + slot * stage;
      const size_t k0 = (size_t)st * SPLIT_KC;
      for (int q = lane; q < 2 * (FB + nt); q += 32) {
        const int h = q & 1, i = q >> 1;
        if (i < FB)
          bulk_load(dst + (i * 2 + h) * SPLIT_KC,
                    Sf + (size_t)i * KS + h * MP + k0, sb, full + slot);
        else
          bulk_load(dst + SF + (i - FB) * SPLIT_TS + h * SPLIT_KC * 8,
                    Hf + (size_t)(tile0 + i - FB) * F * KP * 8 +
                        (h * MP + k0) * 8,
                    hb, full + slot);
      }
    }
    return;
  }

  // a consumer thread: RF frames (from fr0) x CD directions (from dx) of
  // tile g
  int g, dx, fr0;
  if (CD == 4) {
    g = w * 8 + ((lane & 15) >> 1);
    dx = 4 * (lane & 1);
    fr0 = (lane >> 4) * RF;
  } else {
    g = w * 8 + (lane >> 2);
    dx = 2 * (lane & 3);
    fr0 = 0;
  }
  float br[RF][CD], bi[RF][CD];
#pragma unroll
  for (int b = 0; b < RF; ++b)
#pragma unroll
    for (int x = 0; x < CD; ++x) br[b][x] = bi[b][x] = 0.f;
  for (int st = 0; st < nst; ++st) {
    const int slot = st % ns;
    bar_wait(full + slot, (uint32_t)((st / ns) & 1));
    const float* Ss = ring + slot * stage + fr0 * 2 * SPLIT_KC;
    const float* Hs = ring + slot * stage + SF + g * SPLIT_TS + dx;
#pragma unroll
    for (int kk = 0; kk < SPLIT_KC; kk += 4) {
      float hr[4][CD], hm[4][CD];     // rows k (Hr) and k + MP (-Hi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* a = Hs + (kk + e) * 8;
        const float* m = Hs + (SPLIT_KC + kk + e) * 8;
        if constexpr (CD == 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(a);
          const float4 m4 = *reinterpret_cast<const float4*>(m);
          hr[e][0] = a4.x; hr[e][1] = a4.y; hr[e][2] = a4.z; hr[e][3] = a4.w;
          hm[e][0] = m4.x; hm[e][1] = m4.y; hm[e][2] = m4.z; hm[e][3] = m4.w;
        } else {
          const float2 a2 = *reinterpret_cast<const float2*>(a);
          const float2 m2 = *reinterpret_cast<const float2*>(m);
          hr[e][0] = a2.x; hr[e][1] = a2.y;
          hm[e][0] = m2.x; hm[e][1] = m2.y;
        }
      }
#pragma unroll
      for (int b = 0; b < RF; ++b) {
        const float4 r4 =
            *reinterpret_cast<const float4*>(Ss + b * 2 * SPLIT_KC + kk);
        const float4 i4 = *reinterpret_cast<const float4*>(
            Ss + b * 2 * SPLIT_KC + SPLIT_KC + kk);
        const float sr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float si[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int x = 0; x < CD; ++x) {
            br[b][x] = fmaf(si[e], hm[e][x], fmaf(sr[e], hr[e][x], br[b][x]));
            bi[b][x] = fmaf(-sr[e], hm[e][x], fmaf(si[e], hr[e][x], bi[b][x]));
          }
      }
    }
    bar_arrive(empty + slot);
  }
  if (g < nt) {
    // P in the fold's order (split_p_index): a fold block's bins are one
    // contiguous run
    const int d = (tile0 + g) * 8 + dx;
#pragma unroll
    for (int b = 0; b < RF; ++b) {
      float* r = P + split_p_index(b0 + fr0 + b, 0, d, f, F, BP, oq);
      float* i = P + split_p_index(b0 + fr0 + b, 1, d, f, F, BP, oq);
      if constexpr (CD == 4) {
        *reinterpret_cast<float4*>(r) =
            make_float4(br[b][0], br[b][1], br[b][2], br[b][3]);
        *reinterpret_cast<float4*>(i) =
            make_float4(bi[b][0], bi[b][1], bi[b][2], bi[b][3]);
      } else {
        *reinterpret_cast<float2*>(r) = make_float2(br[b][0], br[b][1]);
        *reinterpret_cast<float2*>(i) = make_float2(bi[b][0], bi[b][1]);
      }
    }
  }
}

// shared memory of a fold block: the mbarriers, FOLD_STAGES stages of
// FOLD_FC bins (the Br/Bi rows of its outputs [FC][2 OQ][32], the bases
// [2][FC][TtA]), the head corrections v [Tc][OQ][32], each warp's row
// pointers [nw][Tc + 1] and the warps' sums [nw][OQ][32] (before them, the
// frames' sj rows [OQ][JM])
struct FoldLayout {
  size_t stage, v, rp, red, total;
};
__host__ __device__ inline FoldLayout fold_layout(int oq, int TtA, int Tc,
                                                  int nw, int JM) {
  FoldLayout L;
  L.stage = round128((size_t)FOLD_FC * (2 * oq * 32 + 2 * TtA) * 4);
  L.v = 128 + FOLD_STAGES * L.stage;
  L.rp = L.v + round128((size_t)Tc * oq * 32 * 4);
  L.red = L.rp + round128((size_t)nw * (Tc + 1) * 4);
  const size_t red = (size_t)nw * oq * 32, sjr = (size_t)oq * JM;
  L.total = L.red + (red > sjr ? red : sjr) * 4;
  return L;
}

template <int OQ>
__global__ void __launch_bounds__(32 * FOLD_MAX_WARPS)
equiv_fold_kernel(const float* __restrict__ P, const float* __restrict__ ib1,
                  const float* __restrict__ ib2,
                  const float* __restrict__ sj,
                  const int* __restrict__ wc_ptr,
                  const int* __restrict__ wc_idx,
                  const float* __restrict__ wc_val, float* __restrict__ out,
                  int F, int BP, int DP, int TtA, int n_tail, int Tc, int JM,
                  float inv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = (int)(blockDim.x >> 5), w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, tid = threadIdx.x;
  const FoldLayout L = fold_layout(OQ, TtA, Tc, nw, JM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* vbuf = reinterpret_cast<float*>(smem + L.v);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int d0 = blockIdx.x * 32, nd = min(32, DP - d0);
  const int b0 = blockIdx.y * OQ, Tt = n_tail + Tc;
  const int n_chunks = (F + FOLD_FC - 1) / FOLD_FC;
  constexpr int PR = FOLD_FC * 2 * OQ * 32;   // floats of a stage's rows

  // chunk c (bins c*FC ..) into stage c % FOLD_STAGES, three copies: the
  // block's Br/Bi rows of the bins (one run of P) and their bases
  auto issue = [&](int c) {
    const int f0 = c * FOLD_FC, nb = min(FOLD_FC, F - f0);
    uint64_t* bar = bars + c % FOLD_STAGES;
    float* st = reinterpret_cast<float*>(smem + 128 +
                                         (c % FOLD_STAGES) * L.stage);
    const uint32_t rb = (uint32_t)(nb * 2 * OQ * 32 * 4);
    const uint32_t bb = (uint32_t)(nb * TtA * 4);
    bar_expect(bar, rb + 2 * bb);
    fence_async_shared();
    bulk_load(st, P + split_p_index(b0, 0, d0, f0, F, BP, OQ), rb, bar);
    bulk_load(st + PR, ib1 + (size_t)f0 * TtA, bb, bar);
    bulk_load(st + PR + FOLD_FC * TtA, ib2 + (size_t)f0 * TtA, bb, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < FOLD_STAGES; ++s) bar_init(bars + s);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < FOLD_STAGES && c < n_chunks; ++c) issue(c);

  // the head corrections of the block's outputs, v = sj . Wc from the
  // sparse list, each entry read once for the OQ frames.  A direction's
  // rows d*Tc .. d*Tc + Tc - 1 are one run of the list, and their lengths
  // are skewed (lerp gives every direction M entries, at some directions
  // all in one row), so warp w walks the entries of directions w, w + nw,
  // ... 32 at a time: the neighbouring loads of one run, each entry's row
  // by binary search over the direction's row pointers, then a segmented
  // sum over the lanes in a fixed order (no atomics).  The frames' sj rows
  // are read from shared memory.
  float* sjs = red;                      // free until the finish
  int* rp = reinterpret_cast<int*>(smem + L.rp) + w * (Tc + 1);
  for (int i = tid; i < OQ * JM; i += blockDim.x)
    sjs[i] = sj[(size_t)b0 * JM + i];
  for (int i = tid; i < Tc * OQ * 32; i += blockDim.x) vbuf[i] = 0.f;
  __syncthreads();
  for (int dx = w; Tc > 0 && dx < nd; dx += nw) {
    const int r0 = (d0 + dx) * Tc;
    for (int c = lane; c <= Tc; c += 32) rp[c] = __ldg(wc_ptr + r0 + c);
    __syncwarp();
    const int e1 = rp[Tc];
    for (int base = rp[0]; base < e1; base += 32) {
      const int e = base + lane;
      float p[OQ];
      int c = Tc;                        // past the last row: no segment
      if (e < e1) {
        const int jx = __ldg(wc_idx + e);
        const float wv = __ldg(wc_val + e);
#pragma unroll
        for (int q = 0; q < OQ; ++q) p[q] = sjs[q * JM + jx] * wv;
        int lo = 0, hi = Tc - 1;         // the last row c with rp[c] <= e
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (rp[mid] <= e) lo = mid; else hi = mid - 1;
        }
        c = lo;
      } else {
#pragma unroll
        for (int q = 0; q < OQ; ++q) p[q] = 0.f;
      }
      // inclusive sums over the lanes of each row's segment (rows are
      // non-decreasing over the lanes)
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int cu = __shfl_up_sync(0xffffffffu, c, off);
#pragma unroll
        for (int q = 0; q < OQ; ++q) {
          const float pu = __shfl_up_sync(0xffffffffu, p[q], off);
          if (lane >= off && cu == c) p[q] += pu;
        }
      }
      const int cn = __shfl_down_sync(0xffffffffu, c, 1);
      if (c < Tc && (lane == 31 || cn != c))
#pragma unroll
        for (int q = 0; q < OQ; ++q) vbuf[(c * OQ + q) * 32 + dx] += p[q];
    }
    __syncwarp();
  }

  // warp w owns the samples t0 .. t0 + 7 of its lane's direction
  const int t0 = FOLD_TQ * w;
  float acc[FOLD_TQ][OQ], pw[OQ];
#pragma unroll
  for (int q = 0; q < OQ; ++q) {
    pw[q] = 0.f;
#pragma unroll
    for (int t = 0; t < FOLD_TQ; ++t) acc[t][q] = 0.f;
  }
  const bool upper = t0 + 4 < TtA;   // samples t0 + 4 .. t0 + 7 in the rows
  for (int c = 0; c < n_chunks; ++c) {
    const int nb = min(FOLD_FC, F - c * FOLD_FC);
    bar_wait(bars + c % FOLD_STAGES, (uint32_t)((c / FOLD_STAGES) & 1));
    const float* st = reinterpret_cast<const float*>(
        smem + 128 + (c % FOLD_STAGES) * L.stage);
#pragma unroll 2
    for (int fl = 0; fl < nb; ++fl) {
      const float* rows = st + fl * 2 * OQ * 32 + lane;
      const float* i1 = st + PR + fl * TtA + t0;
      const float* i2 = i1 + FOLD_FC * TtA;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a0 = *reinterpret_cast<const float4*>(i1);
      const float4 c0 = *reinterpret_cast<const float4*>(i2);
      const float4 a1 = upper ? *reinterpret_cast<const float4*>(i1 + 4)
                              : zero;
      const float4 c1 = upper ? *reinterpret_cast<const float4*>(i2 + 4)
                              : zero;
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cb[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int q = 0; q < OQ; ++q) {
        const float xr = rows[q * 32], xi = rows[(OQ + q) * 32];
        pw[q] = fmaf(xr, xr, fmaf(xi, xi, pw[q]));
#pragma unroll
        for (int t = 0; t < FOLD_TQ; ++t)
          acc[t][q] = fmaf(a[t], xr, fmaf(cb[t], xi, acc[t][q]));
      }
    }
    __syncthreads();      // every warp has read the stage: refill it
    if (tid == 0 && c + FOLD_STAGES < n_chunks) issue(c + FOLD_STAGES);
  }

  // this warp's terms of the finish: tails subtracted, the head rows'
  // v^2 - 2 TH v (v from the warps' list walks, visible after the
  // barriers above)
  float part[OQ];
#pragma unroll
  for (int q = 0; q < OQ; ++q) part[q] = 0.f;
#pragma unroll
  for (int t = 0; t < FOLD_TQ; ++t) {
    const int tt = t0 + t;
    if (tt < n_tail) {
#pragma unroll
      for (int q = 0; q < OQ; ++q)
        part[q] = fmaf(-acc[t][q], acc[t][q], part[q]);
    } else if (tt < Tt) {
#pragma unroll
      for (int q = 0; q < OQ; ++q) {
        const float v = vbuf[((tt - n_tail) * OQ + q) * 32 + lane];
        part[q] += v * v - 2.f * acc[t][q] * v;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < OQ; ++q) red[(w * OQ + q) * 32 + lane] = part[q];
  __syncthreads();
  if (w == 0 && lane < nd) {
    // warp 0 holds the Parseval sums; the warps' terms in warp order
#pragma unroll
    for (int q = 0; q < OQ; ++q) {
      float total = pw[q];
      for (int u = 0; u < nw; ++u) total += red[(u * OQ + q) * 32 + lane];
      out[(size_t)(b0 + q) * DP + d0 + lane] = total * inv;
    }
  }
}

template <int FB>
int launch_product(const float* S, const float* H1, float* P, int F, int BP,
                   int KP, int DP, int nc, int ns, int oq,
                   cudaStream_t stream) {
  const size_t smem = split_smem(FB, nc, ns);
  cudaError_t e = cudaFuncSetAttribute(
      equiv_product_kernel<FB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_dg = (DP / 8 + nc * 8 - 1) / (nc * 8);
  dim3 grid(BP / FB, n_dg, F);
  equiv_product_kernel<FB><<<grid, 32 * (nc + 1), smem, stream>>>(
      S, H1, P, F, BP, KP, DP, ns, oq);
  return (int)cudaGetLastError();
}

template <int OQ>
int launch_fold(const float* P, const float* ib1, const float* ib2,
                const float* sj, const int* wc_ptr, const int* wc_idx,
                const float* wc_val, float* out, int F, int BP, int DP,
                int TtA, int n_tail, int Tc, int JM, float inv,
                cudaStream_t stream) {
  const int nw = (n_tail + Tc + FOLD_TQ - 1) / FOLD_TQ;
  const size_t smem = fold_layout(OQ, TtA, Tc, nw, JM).total;
  cudaError_t e = cudaFuncSetAttribute(
      equiv_fold_kernel<OQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((DP + 31) / 32, BP / OQ);
  equiv_fold_kernel<OQ><<<grid, 32 * nw, smem, stream>>>(
      P, ib1, ib2, sj, wc_ptr, wc_idx, wc_val, out, F, BP, DP, TtA, n_tail,
      Tc, JM, inv);
  return (int)cudaGetLastError();
}

template <typename T, int BT>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(equiv_power_kernel<T, BT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int BT>
int launch(const void* S, const void* H1, const float* ib1, const float* ib2,
           const float* sj, const int* wc_ptr, const int* wc_idx,
           const float* wc_val, float* out, int F, int BP, int KP, int DP,
           int TtA, int n_tail, int Tc, int JM, int NS, float inv,
           cudaStream_t stream) {
  const size_t smem =
      layout<T, BT, k1_threads<BT>()>(n_tail + Tc, KP, JM, NS, 0).total;
  cudaError_t e = prepare<T, BT>(smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BP / BT, DP / Plane<T>::TD);
  equiv_power_kernel<T, BT><<<grid, k1_threads<BT>(), smem, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(H1), ib1, ib2, sj,
      wc_ptr, wc_idx, wc_val, out, F, BP, KP, DP, TtA, n_tail, Tc, JM, NS,
      inv);
  return (int)cudaGetLastError();
}

template <typename T, int BT>
int blocks_per_sm(int Tt, int KP, int JM, int NS) {
  const size_t smem =
      layout<T, BT, k1_threads<BT>()>(Tt, KP, JM, NS, 0).total;
  cudaError_t e = prepare<T, BT>(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, equiv_power_kernel<T, BT>, k1_threads<BT>(), smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int dispatch(int bt, const void* S, const void* H1, const float* ib1,
             const float* ib2, const float* sj, const int* wc_ptr,
             const int* wc_idx, const float* wc_val, float* out, int F,
             int BP, int KP, int DP, int TtP, int n_tail, int Tc, int JM,
             int NS, float inv, cudaStream_t st) {
#define ZRT_K1_CASE(BT)                                                     \
  case BT:                                                                  \
    return launch<T, BT>(S, H1, ib1, ib2, sj, wc_ptr, wc_idx, wc_val, out, \
                         F, BP, KP, DP, TtP, n_tail, Tc, JM, NS, inv, st);
  switch (bt) {
    ZRT_K1_CASE(1)
    ZRT_K1_CASE(2)
    ZRT_K1_CASE(4)
    ZRT_K1_CASE(8)
    ZRT_K1_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZRT_K1_CASE
}

}  // namespace

extern "C" {

// S (F, BP, KP + 16 B), H1 (DP/TD, F, KP, TD): float32 (bf16 == 0, TD = 8)
// or bf16 (bf16 == 1, TD = 16).  ib1/ib2 (F, TtP) f32 with TtP = n_tail +
// Tc rounded up to 4; sj (BP, JM) f32,
// wc_ptr (DP*Tc + 1) / wc_idx (nnz) int32 and wc_val (nnz) f32 when Tc > 0
// (may be null otherwise); out (BP, DP) f32.  KP % 128 == 0, DP % TD == 0,
// BP % bt == 0, 2 <= NS <= 8.  Returns a cudaError_t.
int zrt_equiv_power(const void* S, const void* H1, const float* ib1,
                    const float* ib2, const float* sj, const int* wc_ptr,
                    const int* wc_idx, const float* wc_val, float* out, int F,
                    int BP, int KP, int DP, int TtP, int n_tail, int Tc,
                    int JM, int NS, float inv, int bf16, int bt,
                    void* stream) {
  const int TD = bf16 ? 16 : 8;
  if (bt <= 0 || F <= 0 || KP % 128 || DP % TD || BP % bt ||
      TtP != tt_align(n_tail + Tc) || NS < 2 || NS > MAX_STAGES ||
      (Tc > 0 && (sj == nullptr || wc_ptr == nullptr || JM <= 0)))
    return (int)cudaErrorInvalidValue;
  if (Tc == 0) JM = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(bt, S, H1, ib1, ib2, sj, wc_ptr, wc_idx,
                                   wc_val, out, F, BP, KP, DP, TtP, n_tail,
                                   Tc, JM, NS, inv, st);
  return dispatch<float>(bt, S, H1, ib1, ib2, sj, wc_ptr, wc_idx, wc_val,
                         out, F, BP, KP, DP, TtP, n_tail, Tc, JM, NS, inv,
                         st);
}

// K1's FP32 route in two passes, on one stream: the product pass writes
// P, (DP/32 rounded up) x BP x F x 2 x 32 f32 in the fold's order
// (split_p_index), the fold pass reads it.  The inputs as
// zrt_equiv_power's in FP32; fb (1, 2, 4, 8, 16) frames a product block
// and oq (1, 2, 4) a fold block, both dividing BP; nc consumer warps
// (1 .. 4) and ns ring stages (2 .. 8) a product block; n_tail + Tc <= 128
// (one fold warp for each 8 samples).  Returns the first launch's
// cudaError_t, or the second's.
int zrt_equiv_power_split(const float* S, const float* H1, const float* ib1,
                          const float* ib2, const float* sj,
                          const int* wc_ptr, const int* wc_idx,
                          const float* wc_val, float* P, float* out, int F,
                          int BP, int KP, int DP, int TtP, int n_tail,
                          int Tc, int JM, float inv, int fb, int nc, int ns,
                          int oq, void* stream) {
  if (F <= 0 || KP % 128 || DP % 16 || fb <= 0 || oq <= 0 || BP % fb ||
      BP % oq || TtP != tt_align(n_tail + Tc) ||
      n_tail + Tc > FOLD_TQ * FOLD_MAX_WARPS || nc < 1 ||
      nc > SPLIT_MAX_WARPS || ns < 2 || ns > MAX_STAGES ||
      (Tc > 0 && (sj == nullptr || wc_ptr == nullptr || JM <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e;
  switch (fb) {
#define ZRT_PRODUCT(FB) \
  launch_product<FB>(S, H1, P, F, BP, KP, DP, nc, ns, oq, st)
    case 1: e = ZRT_PRODUCT(1); break;
    case 2: e = ZRT_PRODUCT(2); break;
    case 4: e = ZRT_PRODUCT(4); break;
    case 8: e = ZRT_PRODUCT(8); break;
    case 16: e = ZRT_PRODUCT(16); break;
#undef ZRT_PRODUCT
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
#define ZRT_FOLD(OQ)                                                      \
  launch_fold<OQ>(P, ib1, ib2, sj, wc_ptr, wc_idx, wc_val, out, F, BP, DP, \
                  TtP, n_tail, Tc, JM, inv, st)
  switch (oq) {
    case 1: return ZRT_FOLD(1);
    case 2: return ZRT_FOLD(2);
    case 4: return ZRT_FOLD(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZRT_FOLD
}

// Blocks of K1 for frame tile bt and NS ring stages that one SM of the
// current device holds at once (registers, shared memory and threads
// together); a negated cudaError_t on failure.
int zrt_equiv_power_blocks_per_sm(int bf16, int bt, int Tt, int KP, int JM,
                                  int NS) {
  if (KP % 128 || Tt <= 0 || JM < 0 || NS < 2 || NS > MAX_STAGES)
    return -(int)cudaErrorInvalidValue;
  switch (bt * 2 + (bf16 ? 1 : 0)) {
    case 2: return blocks_per_sm<float, 1>(Tt, KP, JM, NS);
    case 3: return blocks_per_sm<__nv_bfloat16, 1>(Tt, KP, JM, NS);
    case 4: return blocks_per_sm<float, 2>(Tt, KP, JM, NS);
    case 5: return blocks_per_sm<__nv_bfloat16, 2>(Tt, KP, JM, NS);
    case 8: return blocks_per_sm<float, 4>(Tt, KP, JM, NS);
    case 9: return blocks_per_sm<__nv_bfloat16, 4>(Tt, KP, JM, NS);
    case 16: return blocks_per_sm<float, 8>(Tt, KP, JM, NS);
    case 17: return blocks_per_sm<__nv_bfloat16, 8>(Tt, KP, JM, NS);
    case 32: return blocks_per_sm<float, 16>(Tt, KP, JM, NS);
    case 33: return blocks_per_sm<__nv_bfloat16, 16>(Tt, KP, JM, NS);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// 1 when the product of this plane type runs on the tensor cores
// (mma.sync, bf16), 0 when it runs FP32 FMAs on the CUDA cores.
int zrt_equiv_power_tensor_cores(int bf16) {
  return bf16 ? (int)Plane<__nv_bfloat16>::mma : (int)Plane<float>::mma;
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
