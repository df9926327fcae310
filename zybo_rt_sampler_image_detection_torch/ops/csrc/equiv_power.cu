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
// What the design does about it:
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
//   output of the block (FP32: the pair k, k + MP per step, four FMAs from
//   two spectra and two H values); the warps' partials are summed once
//   per bin (double-buffered, so one barrier orders them), and the
//   tail/head fold runs once per 4 bins from the reduced Br/Bi rows, each
//   base value feeding up to 8 FMAs from registers.  Blocks of 8 warps;
//   16 at frame tile 16, where one block fills an SM and each bin's
//   latency needs more warps to hide.
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
// What is left (measured, PERF.md): at 16 frames a block's time per bin is
// several times its FP32 FMA issue time; neither more ring stages, smaller
// frame tiles, nor sharing the spectra rows across a cluster of blocks
// (TMA multicast) made it faster.
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
