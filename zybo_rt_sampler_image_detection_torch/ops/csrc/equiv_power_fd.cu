// Fused exact frequency-domain steered power in the direction-innermost
// order (the "fd" sweep) for Hopper.
//
// Replaces the Pallas TPU kernel
// zybo_rt_sampler_image_detection_tpu/ops/equiv_kernel.py::_equiv_power_kernel_fd.
// It computes the function of equiv_power.cu (K1), on K1's inputs (one
// response plane H1, the sparse head-correction list) and with K1's product
// core (equiv_core.cuh), in the TPU kernel's order: the FP bins are cut
// into n_fc chunks of fc, and a block sweeps the direction axis innermost.
//
// What bounds it on an H100: the same work as K1, so the same bound (H1
// read once, 0.58 GB in FP32 at the reference shape; the FP32 FMAs at 16
// frames).  What the order changes is the traffic in S: K1 restages its
// frames' spectra for every direction tile (from L2); here a block stages
// its S chunk once and reuses it for every tile of its direction group.
//
// What the design does about it:
// * Grid (BP/BT frame tiles, n_dg direction groups, n_fc chunks), frame
//   tiles fastest, so the blocks that read the same H tiles run together
//   and share them through L2.  The host picks the frame tile and n_dg from
//   the blocks an SM holds as the runtime reports them
//   (zrt_equiv_power_fd_blocks_per_sm), so the grid fills every SM even at
//   one frame without a short last wave.
// * A block copies its S chunk (fc bins x BT rows, in the plane type) into
//   shared memory once with bulk copies, then streams the H tiles of its
//   (direction tile, bin) steps through a ring of NS stages, and the bases
//   of each fold, as K1 does.  Per step it runs K1's product, the
//   once-a-bin reduction over warps and the tail/head fold every 4 bins
//   (bf16 on the tensor cores; the staged bf16 rows are the MMA operands,
//   nothing is converted in the loop).  From frame tile 8 up a block has
//   16 warps: its S chunk leaves room for one block an SM.
// * At the end of a tile each (chunk, b, d) writes its partial Parseval sum
//   to pow_part (n_fc, DP/TD, BP, TD) and its Tt partial tail/head samples
//   to th_part (n_fc, Tt, DP/TD, BP, TD): the port's form of the TPU's
//   aliased pow0/th0 windows, laid out so that a tile's cells are one
//   contiguous run (whole lines for the finish's reads).
// * A second, small kernel on the same stream sums the partials in chunk
//   order (eight loads in flight) and runs K1's finish: the head
//   corrections from the sparse list (each entry read once per frame
//   tile), the tails subtracted.  No atomics: the result is deterministic.
// * Precision as K1: FP32 FMAs (f32/high) or bf16 MMAs with FP32
//   accumulation (bf16); the tail/head term and the finish are FP32.
//
// Plain C interface, loaded with ctypes; both launches go on the caller's
// stream and the function returns cudaGetLastError().

#include "equiv_core.cuh"

namespace {

using namespace zrt_equiv;

template <typename T, int BT>
__global__ void __launch_bounds__(fd_threads<BT>())
equiv_power_fd_kernel(const T* __restrict__ S, const T* __restrict__ H1,
                      const float* __restrict__ ib1,
                      const float* __restrict__ ib2,
                      float* __restrict__ pow_part,
                      float* __restrict__ th_part, int FP, int BP, int KP,
                      int DP, int TtA, int Tt, int fc, int NS) {
  constexpr int TD = Plane<T>::TD, NO = BT * TD, NR = 2 * NO;
  constexpr int NT = fd_threads<BT>(), KSPL = k_split<T, BT, NT>();
  constexpr int G = NT / NO;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<T, BT, NT>(Tt, KP, 0, NS, fc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int KS = KP + Plane<T>::KPAD;
  const size_t s_bin = (size_t)BT * KS;                 // elements
  T* schunk = reinterpret_cast<T*>(smem + L.area0);     // [fc][BT][KS]
  unsigned char* ring = smem + L.area0 + fc * s_bin * sizeof(T);
  float* th = reinterpret_cast<float*>(smem + L.th);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* brbi = reinterpret_cast<float*>(smem + L.brbi);
  float* ibs = reinterpret_cast<float*>(smem + L.ibs);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int chunk = blockIdx.z, f0 = chunk * fc;
  const int n_tiles = DP / TD;
  // this block's tiles: blockIdx.y, + gridDim.y, ...; steps (tile j, bin)
  const int my_tiles = (n_tiles - (int)blockIdx.y + (int)gridDim.y - 1) /
                       (int)gridDim.y;
  const int n_steps = my_tiles * fc;
  // fold chunks of FCB bins, restarting at every tile
  const int per_tile = (fc + FCB - 1) / FCB, n_chunks = my_tiles * per_tile;
  const uint32_t h_bytes = (uint32_t)(KP * TD * sizeof(T));
  const size_t out_plane = (size_t)BP * DP;

  auto issue = [&](int step) {
    const int tile = blockIdx.y + (step / fc) * gridDim.y;
    const int f = f0 + step % fc;
    uint64_t* bar = bars + step % NS;
    bar_expect(bar, h_bytes);
    bulk_load(ring + (size_t)(step % NS) * h_bytes,
              H1 + ((size_t)tile * FP + f) * KP * TD, h_bytes, bar);
  };
  auto issue_ib = [&](int c) {
    const int fl = (c % per_tile) * FCB;
    const int nb = fc - fl < FCB ? fc - fl : FCB;
    issue_bases(ibs + (size_t)(c & 1) * 2 * FCB * TtA, ib1, ib2, f0 + fl, nb,
                TtA, bars + IB_BAR + (c & 1));
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) bar_init(bars + s);
    bar_init(bars + IB_BAR);
    bar_init(bars + IB_BAR + 1);
    bar_init(bars + S_BAR);
    bar_init_fence();
  }
  for (int i = tid; i < Tt * NO; i += NT) th[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    // the S chunk, once: fc runs of BT rows, one bulk copy each
    const uint32_t sb = (uint32_t)(s_bin * sizeof(T));
    bar_expect(bars + S_BAR, sb * fc);
    for (int fl = 0; fl < fc; ++fl)
      bulk_load(schunk + fl * s_bin, S + ((size_t)(f0 + fl) * BP + b0) * KS,
                sb, bars + S_BAR);
    for (int s = 0; s < NS && s < n_steps; ++s) issue(s);
    for (int c = 0; c < 2 && c < n_chunks; ++c) issue_ib(c);
  }
  bar_wait(bars + S_BAR, 0);

  float pw = 0.f;
  int folds = 0, fb = 0;
  for (int step = 0; step < n_steps; ++step) {
    const int fl = step % fc, s = step % NS;
    bar_wait(bars + s, (uint32_t)((step / NS) & 1));
    float* rp = red + (size_t)(step & 1) * KSPL * NR;
    product<BT, NT>(schunk + fl * s_bin,
                reinterpret_cast<const T*>(ring + (size_t)s * h_bytes), KP,
                rp);
    __syncthreads();
    if (tid == 0) {
      fence_async_shared();
      if (step + NS < n_steps) issue(step + NS);
      if (fl == fb && folds >= 1 && folds + 1 < n_chunks) issue_ib(folds + 1);
    }
    float* dst = brbi + (size_t)(folds & 1) * FCB * NR;
    reduce<T, BT, NT>(rp, dst + (size_t)(fl - fb) * NR);
    if (fl - fb + 1 == FCB || fl == fc - 1) {
      __syncthreads();
      bar_wait(bars + IB_BAR + (folds & 1), (uint32_t)((folds >> 1) & 1));
      fold<T, BT, NT>(th, dst, fl - fb + 1,
                  ibs + (size_t)(folds & 1) * 2 * FCB * TtA, TtA, Tt, pw);
      ++folds;
      fb = fl + 1;
    }
    if (fl == fc - 1) {
      // this chunk's partials of the tile (the fold's owners differ from
      // these, hence the barrier); each (t, o) then has one owner here
      __syncthreads();
      const int tile = blockIdx.y + (step / fc) * gridDim.y;
      const int o = tid % NO, g = tid / NO;
      const size_t cell = ((size_t)tile * BP + b0) * TD + o;
      if (tid < NO) pow_part[chunk * out_plane + cell] = pw;
      for (int t = g; t < Tt; t += G) {
        th_part[((size_t)chunk * Tt + t) * out_plane + cell] = th[t * NO + o];
        th[t * NO + o] = 0.f;
      }
      pw = 0.f;
      fb = 0;
    }
  }
}

// p[0] + p[stride] + ... over n chunks, in chunk order, eight loads in
// flight at a time.
__device__ __forceinline__ float chunk_sum(const float* __restrict__ p,
                                           size_t stride, int n) {
  float x = 0.f;
  int c = 0;
  for (; c + 8 <= n; c += 8) {
    float y[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) y[q] = p[(size_t)(c + q) * stride];
#pragma unroll
    for (int q = 0; q < 8; ++q) x += y[q];
  }
  for (; c < n; ++c) x += p[(size_t)c * stride];
  return x;
}

// The finish: a block per (frame tile, direction tile), frame tiles
// fastest.  Every thread sums (t, o) pairs of the tile's tail/head partials
// in chunk order into shared memory, the chunks' Parseval partials go to
// the owner threads, then K1's finish (sparse corrections, tails, scale).
template <typename T, int BT>
__global__ void __launch_bounds__(fd_threads<BT>())
equiv_power_fd_finish(const float* __restrict__ pow_part,
                      const float* __restrict__ th_part,
                      const float* __restrict__ sj,
                      const int* __restrict__ wc_ptr,
                      const int* __restrict__ wc_idx,
                      const float* __restrict__ wc_val,
                      float* __restrict__ out, int BP, int DP, int n_fc,
                      int n_tail, int Tc, int JM, float inv) {
  constexpr int TD = Plane<T>::TD, NO = BT * TD, NT = fd_threads<BT>();
  extern __shared__ __align__(16) float fsm[];
  const int Tt = n_tail + Tc;
  float* srows = fsm;                          // [BT][JM]
  float* th = srows + (size_t)BT * JM;         // [Tt][NO]
  float* scratch = th + (size_t)Tt * NO;       // [NT]
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BT, d0 = blockIdx.y * TD;
  const size_t out_plane = (size_t)BP * DP;

  for (int i = tid; i < BT * JM; i += NT) srows[i] = sj[(size_t)b0 * JM + i];
  // the tile's NO cells are contiguous in every (chunk, t) plane
  const size_t tile0 = ((size_t)blockIdx.y * BP + b0) * TD;
  for (int i = tid; i < Tt * NO; i += NT) {
    const int t = i / NO, oi = i % NO;
    th[i] = chunk_sum(th_part + (size_t)t * out_plane + tile0 + oi,
                      (size_t)Tt * out_plane, n_fc);
  }
  float pw = 0.f;
  if (tid < NO) pw = chunk_sum(pow_part + tile0 + tid, out_plane, n_fc);
  __syncthreads();
  finish<T, BT, NT>(th, srows, JM, scratch, pw, wc_ptr, wc_idx, wc_val, d0,
                    n_tail, Tc, inv, out, b0, DP);
}

template <typename T, int BT>
size_t chunk_smem(int KP, int fc, int Tt, int NS) {
  return layout<T, BT, fd_threads<BT>()>(Tt, KP, 0, NS, fc).total;
}

template <typename T, int BT>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(equiv_power_fd_kernel<T, BT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int BT>
int blocks_per_sm(int KP, int fc, int Tt, int NS) {
  const size_t smem = chunk_smem<T, BT>(KP, fc, Tt, NS);
  cudaError_t e = prepare<T, BT>(smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, equiv_power_fd_kernel<T, BT>, fd_threads<BT>(), smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, int BT>
int launch(const void* S, const void* H1, const float* ib1, const float* ib2,
           const float* sj, const int* wc_ptr, const int* wc_idx,
           const float* wc_val, float* pow_part, float* th_part, float* out,
           int FP, int BP, int KP, int DP, int TtP, int n_tail, int Tc,
           int JM, int n_fc, int n_dg, int NS, float inv,
           cudaStream_t stream) {
  constexpr int TD = Plane<T>::TD;
  const int Tt = n_tail + Tc, fc = FP / n_fc;
  const size_t smem = chunk_smem<T, BT>(KP, fc, Tt, NS);
  cudaError_t e = prepare<T, BT>(smem);
  if (e != cudaSuccess) return (int)e;
  equiv_power_fd_kernel<T, BT><<<dim3(BP / BT, n_dg, n_fc),
                                 fd_threads<BT>(), smem, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(H1), ib1, ib2,
      pow_part, th_part, FP, BP, KP, DP, TtP, Tt, fc, NS);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // sj rows, the Tt x BT*TD tail/head sums and a float a thread of scratch
  const size_t fsmem =
      sizeof(float) *
      ((size_t)BT * JM + (size_t)Tt * BT * TD + fd_threads<BT>());
  e = cudaFuncSetAttribute(equiv_power_fd_finish<T, BT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)fsmem);
  if (e != cudaSuccess) return (int)e;
  equiv_power_fd_finish<T, BT><<<dim3(BP / BT, DP / TD), fd_threads<BT>(),
                                 fsmem, stream>>>(
      pow_part, th_part, sj, wc_ptr, wc_idx, wc_val, out, BP, DP, n_fc,
      n_tail, Tc, JM, inv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int bt, const void* S, const void* H1, const float* ib1,
             const float* ib2, const float* sj, const int* wc_ptr,
             const int* wc_idx, const float* wc_val, float* pp, float* tp,
             float* out, int FP, int BP, int KP, int DP, int TtP, int n_tail,
             int Tc, int JM, int n_fc, int n_dg, int NS, float inv,
             cudaStream_t st) {
#define ZRT_K5_CASE(BT)                                                     \
  case BT:                                                                  \
    return launch<T, BT>(S, H1, ib1, ib2, sj, wc_ptr, wc_idx, wc_val, pp,  \
                         tp, out, FP, BP, KP, DP, TtP, n_tail, Tc, JM, n_fc, \
                         n_dg, NS, inv, st);
  switch (bt) {
    ZRT_K5_CASE(1)
    ZRT_K5_CASE(2)
    ZRT_K5_CASE(4)
    ZRT_K5_CASE(8)
    ZRT_K5_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ZRT_K5_CASE
}

}  // namespace

extern "C" {

// S (FP, BP, KP + 16 B), H1 (DP/TD, FP, KP, TD): float32 (bf16 == 0, TD =
// 8) or bf16 (bf16 == 1, TD = 16).  ib1/ib2 (FP, TtP) f32 with TtP = n_tail
// + Tc rounded up to 4; sj (BP, JM) f32,
// wc_ptr (DP*Tc + 1) / wc_idx (nnz) int32 and wc_val (nnz) f32 when Tc > 0
// (may be null otherwise); pow_part (n_fc, DP/TD, BP, TD) and th_part
// (n_fc, n_tail + Tc, DP/TD, BP, TD) f32 scratch; out (BP, DP) f32.
// FP % n_fc == 0, KP % 128 == 0, DP % TD == 0, BP % bt == 0, 2 <= NS <= 8
// ring stages.  Returns a cudaError_t.
int zrt_equiv_power_fd(const void* S, const void* H1, const float* ib1,
                       const float* ib2, const float* sj, const int* wc_ptr,
                       const int* wc_idx, const float* wc_val,
                       float* pow_part, float* th_part, float* out, int FP,
                       int BP, int KP, int DP, int TtP, int n_tail, int Tc,
                       int JM, int n_fc, int n_dg, int NS, float inv,
                       int bf16, int bt, void* stream) {
  const int TD = bf16 ? 16 : 8;
  if (bt <= 0 || n_fc <= 0 || n_dg <= 0 || FP % n_fc || KP % 128 ||
      DP % TD || BP % bt || TtP != tt_align(n_tail + Tc) || NS < 2 ||
      NS > MAX_STAGES ||
      (Tc > 0 && (sj == nullptr || wc_ptr == nullptr || JM <= 0)))
    return (int)cudaErrorInvalidValue;
  if (Tc == 0) JM = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(bt, S, H1, ib1, ib2, sj, wc_ptr, wc_idx,
                                   wc_val, pow_part, th_part, out, FP, BP, KP,
                                   DP, TtP, n_tail, Tc, JM, n_fc, n_dg, NS,
                                   inv, st);
  return dispatch<float>(bt, S, H1, ib1, ib2, sj, wc_ptr, wc_idx, wc_val,
                         pow_part, th_part, out, FP, BP, KP, DP, TtP, n_tail,
                         Tc, JM, n_fc, n_dg, NS, inv, st);
}

// Blocks of the chunk kernel for frame tile bt, fc bins a chunk, n_tail +
// Tc = Tt and NS ring stages that one SM of the current device holds at
// once; a negated cudaError_t on failure.
int zrt_equiv_power_fd_blocks_per_sm(int bf16, int bt, int KP, int fc,
                                     int Tt, int NS) {
  if (KP % 128 || fc <= 0 || Tt <= 0 || NS < 2 || NS > MAX_STAGES)
    return -(int)cudaErrorInvalidValue;
  switch (bt * 2 + (bf16 ? 1 : 0)) {
    case 2: return blocks_per_sm<float, 1>(KP, fc, Tt, NS);
    case 3: return blocks_per_sm<__nv_bfloat16, 1>(KP, fc, Tt, NS);
    case 4: return blocks_per_sm<float, 2>(KP, fc, Tt, NS);
    case 5: return blocks_per_sm<__nv_bfloat16, 2>(KP, fc, Tt, NS);
    case 8: return blocks_per_sm<float, 4>(KP, fc, Tt, NS);
    case 9: return blocks_per_sm<__nv_bfloat16, 4>(KP, fc, Tt, NS);
    case 16: return blocks_per_sm<float, 8>(KP, fc, Tt, NS);
    case 17: return blocks_per_sm<__nv_bfloat16, 8>(KP, fc, Tt, NS);
    case 32: return blocks_per_sm<float, 16>(KP, fc, Tt, NS);
    case 33: return blocks_per_sm<__nv_bfloat16, 16>(KP, fc, Tt, NS);
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
