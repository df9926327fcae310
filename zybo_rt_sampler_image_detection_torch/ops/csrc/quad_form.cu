// The MVDR route's quadratic form in two kernels:
//
//   d[f, x] = Re(a^H P_f a),   a = conj(phase[f, :, x]),
//
// for every bin f and direction x, in FP32 on the CUDA cores, from the
// (F, M, M) complex64 P and the (F, M, D) complex64 steering tensor in
// the tile layout the port keeps beside it.  Nothing of size (F, M, D) is
// written: the product P a stays in registers and is folded into d at
// once, and no conjugated copy of the tensor is made.
//
// It replaces no TPU kernel: the JAX package leaves this form to XLA.  It
// exists because the library chain it replaced (cuBLAS's complex GEMM of
// conj(P) by the tensor, then an elementwise product and a reduction over
// the mics, and conj copies) wrote and re-read a 356 MB product and read
// the tensor twice at the MVDR cell's shape (127 bins, 192 mics, 1,824
// directions), and multiplied all of P.
//
// Only P's Hermitian half is multiplied.  With 32-mic tiles I, J and
// Ph = (P + P^H) / 2, exactly (Re(a^H P^H a) = Re(a^H P a)):
//
//   d = sum_I Re(a_I^H Ph_II a_I) + sum_{I<J} Re(a_I^H (P_IJ + P_JI^H) a_J)
//
// so a bin takes the tile pairs I <= J (21 of 36 at 192 mics), each tile
// of the sum made from P's two triangles as they are: the result is the
// form of the P it is given, Hermitian or not.  Only the order of the FP32
// sums differs from the full form's.
//
// What bounds it on an H100: the FP32 FMAs of the half, 2 M (M + 32) a
// bin and direction at whole tiles (39.8 GFLOP at the cell's shape, 0.59
// ms at 67 TFLOP/s); the tensor's bytes (356 MB, 0.106 ms at 3.35 TB/s)
// are read once and stream beside them.  So the design keeps the FMA
// pipes fed and the FMAs' operands few:
//
// * quad_form_pack_kernel makes the tiles of the sum once a call, C_IJ =
//   P_IJ + P_JI^H (the diagonal tile halved, zero past M), column-major
//   (C[k][r], r in tile I, k in tile J), a bin's tiles one run in the
//   order the main kernel takes them: 21.8 MB at the cell's shape, so the
//   main kernel reads one 8 KB bulk copy a pair, not both triangles.
// * quad_form_kernel is persistent (a block an SM) and walks work items
//   of one bin and DT = 64 directions.  It reads the tensor in the
//   Bartlett kernel's tile layout (FreqTables.phase_tiles: chunks of DC
//   directions, a multiple of 16, zero past D), so that an item's row of
//   a mic is one 16-byte aligned run.  An item's steering rows (M x 64
//   complex64) are staged once in shared memory with a bulk copy a row,
//   a 32-mic tile at a time, each on its own mbarriers.  The pairs go in
//   rows of tiles I = 0, 1, ...; after row I, tile I of this item is read
//   no more, so the next item's tile I is copied into its place: the next
//   item's data stream in behind this item's FMAs.  The C tiles stream
//   through a ring of bulk copies.  A ninth warp issues every copy as the
//   eight others release a ring slot or a steering tile on its mbarrier,
//   so that no FMA warp runs the copies' bookkeeping; the FMA warps wait
//   on each other only once an item.
// * 8 FMA warps: 2 groups of 32 directions x 4 quarters of a tile's 32
//   columns.  A lane owns 8 rows x 4 directions of T = C conj(a_J) (64
//   registers); its lanes take 4 rows apart x 8 directions apart, so that
//   each of a column's four 16-byte loads of C and two of the tensor is
//   one shared-memory wavefront, for 128 FMAs.  T runs over a row of tiles
//   in registers; at its end it is folded into d (Re(ph_I . T)) and
//   cleared.  At the item's end the lanes' and warps' partial d are summed
//   in a fixed order: no atomics, so every call is bitwise repeatable.
//
// ops/quad_form_kernel.py checks the shapes and allocates the tiles.

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

constexpr int TM = 32;           // mics of a tile
constexpr int DT = 64;           // directions of a work item
constexpr int XP = 4;            // directions of a lane (8 dir lanes apart)
constexpr int NG = DT / (8 * XP);  // direction groups of the item
constexpr int NW = 8;            // consumer warps: NG direction groups x NQ
                                 // column splits; warp NW is the producer
constexpr int NQ = NW / NG;      // splits of a tile's columns
constexpr int NTH = 32 * (NW + 1);
constexpr int KQ = TM / NQ;      // columns of a warp's split
constexpr int MAX_TILES = 8;     // M <= MAX_TILES * TM
constexpr int MAX_RING = 8;      // C tiles in flight
constexpr int HEAD = 512;        // bytes of mbarriers
constexpr int TILE = TM * TM;    // float2 of a C tile

// the pair (I, J) of index p in a bin's run, rows of tiles in order
__host__ __device__ inline void pair_of(int p, int nt, int& I, int& J) {
  I = 0;
  while (p >= nt - I) {
    p -= nt - I;
    ++I;
  }
  J = I + p;
}

// C tiles of the sum, (F, npairs, TM, TM): block (p, f), C[k][r]
__global__ void __launch_bounds__(256)
quad_form_pack_kernel(const float2* __restrict__ P, float2* __restrict__ C,
                      int M, int nt) {
  __shared__ float2 A[TM][TM + 1];
  const int p = blockIdx.x, f = blockIdx.y, npairs = gridDim.x;
  int I, J;
  pair_of(p, nt, I, J);
  const float2* Pf = P + (size_t)f * M * M;
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int r = I * TM + e / TM, k = J * TM + e % TM;
    A[e / TM][e % TM] =
        r < M && k < M ? Pf[(size_t)r * M + k] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  float2* Cp = C + ((size_t)f * npairs + p) * TILE;
  for (int e = threadIdx.x; e < TILE; e += blockDim.x) {
    const int k = e / TM, r = e % TM;
    const float2 a = A[r][k];
    float2 b;
    if (I == J) {
      b = A[k][r];
    } else {
      const int gr = J * TM + k, gk = I * TM + r;
      b = gr < M && gk < M ? Pf[(size_t)gr * M + gk] : make_float2(0.f, 0.f);
    }
    float2 v = make_float2(a.x + b.x, a.y - b.y);
    if (I == J) v = make_float2(0.5f * v.x, 0.5f * v.y);
    Cp[e] = v;
  }
}

// shared memory of the main kernel: the mbarriers (full[MAX_RING],
// empty[MAX_RING], sfull[MAX_TILES], sempty[MAX_TILES]), then in float2
// the steering rows [nt * TM][DT], the ring of C tiles [ring][TM][TM], and
// in float the column splits' partial d of two items [2][NQ][DT]
inline size_t smem_bytes(int nt, int ring) {
  return HEAD + ((size_t)nt * TM * DT + (size_t)ring * TILE) * 8 +
         2 * NQ * DT * 4;
}

// A position in the block's sequence of tile pairs: its item (the
// block's n-th), the pair (I, J) and its index p in the bin's run.
struct Cursor {
  int n, I, J, p;
  __device__ __forceinline__ void advance(int nt) {
    ++p;
    if (++J == nt) {
      if (++I == nt) {
        ++n;
        I = 0;
        p = 0;
      }
      J = I;
    }
  }
};

// Work items: a bin f and up to DT directions of one chunk c of the
// tensor's tile layout (NC, F, M, DC), sub-item s of the chunk's
// spc = ceil(DC / DT); a bin's ni items are those that start below D.
__global__ void __launch_bounds__(NTH, 1)
quad_form_kernel(const float2* __restrict__ C, const float2* __restrict__ Pt,
                 float* __restrict__ out, int F, int M, int D, int DC,
                 int spc, int ni, int ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_RING;
  uint64_t* sfull = empty + MAX_RING;
  uint64_t* sempty = sfull + MAX_TILES;
  const int nt = (M + TM - 1) / TM;
  float2* sa = reinterpret_cast<float2*>(smem + HEAD);
  float2* ring_c = sa + (size_t)nt * TM * DT;
  float* red = reinterpret_cast<float*>(ring_c + (size_t)ring * TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int items = F * ni;
  const int n_items = ((int)blockIdx.x < items)
                          ? (items - (int)blockIdx.x + (int)gridDim.x - 1) /
                                (int)gridDim.x
                          : 0;
  if (n_items == 0) return;
  const int npairs = nt * (nt + 1) / 2;
  const long total = (long)n_items * npairs;
  auto item_of = [&](int n) { return (int)blockIdx.x + n * (int)gridDim.x; };

  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      bar_init(full + s);
      bar_init(empty + s, NW);         // one arrival a consumer warp
    }
    for (int t = 0; t < nt; ++t) {
      bar_init(sfull + t);
      bar_init(sempty + t, NW);
    }
    bar_init_fence();
  }
  // zeros in the steering rows past M, which no copy writes, and in the
  // columns past a narrow item's width until a copy writes them
  for (int e = tid; e < nt * TM * DT; e += NTH) sa[e] = make_float2(0.f, 0.f);
  __syncthreads();

  // steering tile t of the block's n-th item: one warp's bulk copies, a
  // row (the item's width of a chunk's row, 16-byte multiples) a lane
  auto load_steer = [&](int n, int t) {
    const int item = item_of(n), f = item / ni, i = item % ni;
    const int c = i / spc, s0 = (i % spc) * DT;
    const int rows = min(TM, M - t * TM), w = min(DT, DC - s0);
    if (lane == 0) bar_expect(sfull + t, (uint32_t)(rows * w * 8));
    __syncwarp();
    fence_async_shared();
    if (lane < rows)
      bulk_load(sa + (size_t)(t * TM + lane) * DT,
                Pt + (((size_t)c * F + f) * M + t * TM + lane) * DC + s0,
                (uint32_t)(w * 8), sfull + t);
  };
  // the C tile of the pair at c into ring slot s: one thread's bulk copy
  auto issue = [&](const Cursor& c, int s) {
    const int f = item_of(c.n) / ni;
    fence_async_shared();
    bar_expect(full + s, TILE * 8);
    bulk_load(ring_c + (size_t)s * TILE,
              C + ((size_t)f * npairs + c.p) * TILE, TILE * 8, full + s);
  };

  if (warp == NW) {
    // the producer: the first item's steering and the ring's first C
    // tiles, then, as the consumers release a slot, the tile ring pairs
    // on and, as they release a steering tile, the next item's copy of
    // it (the pair released last in a row of tiles frees the row's
    // tile, once the consumers' folds are done with it)
    for (int t = 0; t < nt; ++t) load_steer(0, t);
    Cursor c = {0, 0, 0, 0}, r = c;
    int s = 0;
    uint32_t parity = 0;
    for (long q = 0; q < total + ring; ++q) {
      if (q >= ring) {
        bar_wait(empty + s, parity ^ 1);
        if (r.J == nt - 1 && r.n + 1 < n_items) {
          bar_wait(sempty + r.I, (uint32_t)(r.n & 1));
          load_steer(r.n + 1, r.I);
        }
        r.advance(nt);
      }
      if (q < total) {
        if (lane == 0) issue(c, s);
        c.advance(nt);
      }
      if (++s == ring) {
        s = 0;
        parity ^= 1;
      }
    }
    return;
  }

  // this lane: rows 8 i + 2 j + {0, 1} of a tile (i < 4), directions
  // 8 XP dg + 16 i' + 2 m + {0, 1} of the item (i' < XP / 2), columns
  // KQ kq ..
  const int j = lane & 3, m = lane >> 2;
  const int dg = warp / NQ, kq = warp % NQ;
  const int xo = 8 * XP * dg + 2 * m;
  float tr[8][XP], ti[8][XP];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int x = 0; x < XP; ++x) tr[r][x] = ti[r][x] = 0.f;
  float dacc[XP];
#pragma unroll
  for (int x = 0; x < XP; ++x) dacc[x] = 0.f;

  // cur: the pair this trip takes, in ring slot s of phase parity
  Cursor cur = {0, 0, 0, 0};
  int s = 0;
  uint32_t parity = 0;
  for (long q = 0; q < total; ++q) {
    const int I = cur.I, J = cur.J, n = cur.n;
    if (I == 0) bar_wait(sfull + J, (uint32_t)(n & 1));   // its first use
    bar_wait(full + s, parity);
    {
      // T += C conj(a_J) over this warp's quarter of the columns, the
      // next column's operands loaded before this one's FMAs
      const float2* cb = ring_c + (size_t)s * TILE + kq * KQ * TM + 2 * j;
      const float2* ab = sa + (size_t)(J * TM + kq * KQ) * DT + xo;
      float4 cv[2][4], pv[2][XP / 2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[0][i] = *reinterpret_cast<const float4*>(cb + 8 * i);
#pragma unroll
      for (int i = 0; i < XP / 2; ++i)
        pv[0][i] = *reinterpret_cast<const float4*>(ab + 16 * i);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const int b = kk & 1;
        if (kk + 1 < KQ) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[b ^ 1][i] = *reinterpret_cast<const float4*>(
                cb + (kk + 1) * TM + 8 * i);
#pragma unroll
          for (int i = 0; i < XP / 2; ++i)
            pv[b ^ 1][i] = *reinterpret_cast<const float4*>(
                ab + (size_t)(kk + 1) * DT + 16 * i);
        }
        float cr[8], ci[8], pr[XP], pi[XP];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cr[2 * i] = cv[b][i].x;
          ci[2 * i] = cv[b][i].y;
          cr[2 * i + 1] = cv[b][i].z;
          ci[2 * i + 1] = cv[b][i].w;
        }
#pragma unroll
        for (int i = 0; i < XP / 2; ++i) {
          pr[2 * i] = pv[b][i].x;
          pi[2 * i] = pv[b][i].y;
          pr[2 * i + 1] = pv[b][i].z;
          pi[2 * i + 1] = pv[b][i].w;
        }
        // as two real outer products, (Cr, Ci) x pr then (Ci, -Cr) x pi,
        // a direction's operand held over 16 FMAs in a row
#pragma unroll
        for (int x = 0; x < XP; ++x)
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            tr[r][x] = fmaf(cr[r], pr[x], tr[r][x]);
            ti[r][x] = fmaf(ci[r], pr[x], ti[r][x]);
          }
#pragma unroll
        for (int x = 0; x < XP; ++x)
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            tr[r][x] = fmaf(ci[r], pi[x], tr[r][x]);
            ti[r][x] = fmaf(-cr[r], pi[x], ti[r][x]);
          }
      }
    }
    // release the slot to the producer
    __syncwarp();
    if (lane == 0) bar_arrive(empty + s);
    if (J == nt - 1) {
      // the row of tiles is done: d += Re(ph_I . T), then T = 0
      const float2* qb = sa + (size_t)(I * TM + 2 * j) * DT + xo;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float2* row = qb + (size_t)(8 * (r >> 1) + (r & 1)) * DT;
#pragma unroll
        for (int i = 0; i < XP / 2; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(row + 16 * i);
          dacc[2 * i] = fmaf(v.x, tr[r][2 * i],
                             fmaf(-v.y, ti[r][2 * i], dacc[2 * i]));
          dacc[2 * i + 1] = fmaf(v.z, tr[r][2 * i + 1],
                                 fmaf(-v.w, ti[r][2 * i + 1],
                                      dacc[2 * i + 1]));
        }
#pragma unroll
        for (int x = 0; x < XP; ++x) tr[r][x] = ti[r][x] = 0.f;
      }
      // tile I of this item is done with here: release it to the
      // producer, which copies the next item's tile I into its place
      __syncwarp();
      if (lane == 0) bar_arrive(sempty + I);
      if (I == nt - 1) {
        // the item is done: the lanes' sums over their rows, then the
        // quarters' in order
#pragma unroll
        for (int x = 0; x < XP; ++x) {
          dacc[x] += __shfl_xor_sync(0xffffffffu, dacc[x], 1);
          dacc[x] += __shfl_xor_sync(0xffffffffu, dacc[x], 2);
        }
        float* rd = red + (n & 1) * NQ * DT + kq * DT + xo;
        if (j == 0) {
#pragma unroll
          for (int i = 0; i < XP / 2; ++i) {
            rd[16 * i] = dacc[2 * i];
            rd[16 * i + 1] = dacc[2 * i + 1];
          }
        }
#pragma unroll
        for (int x = 0; x < XP; ++x) dacc[x] = 0.f;
        asm volatile("bar.sync 1, %0;\n" ::"r"(32 * NW) : "memory");
        if (tid < DT) {
          const int item = item_of(n), i = item % ni;
          const int s0 = (i % spc) * DT;
          const int x = (i / spc) * DC + s0 + tid;
          if (tid < DC - s0 && x < D) {
            const float* rs = red + (n & 1) * NQ * DT + tid;
            float v = rs[0];
#pragma unroll
            for (int k = 1; k < NQ; ++k) v += rs[k * DT];
            out[(size_t)(item / ni) * D + x] = v;
          }
        }
      }
    }
    cur.advance(nt);
    if (++s == ring) {
      s = 0;
      parity ^= 1;
    }
  }
}

}  // namespace

extern "C" {

// d (F, D) float32 into out from P (F, M, M) complex64 and the tensor in
// its tile layout (NC, F, M, DC) complex64 (DC a multiple of 16, zero past
// D), through the C tiles (F, npairs, 32, 32) complex64 in cbuf, npairs =
// nt (nt + 1) / 2, nt = ceil(M / 32).  Returns a cudaError_t.
int zrt_quad_form(const void* P, const void* Pt, void* cbuf, float* out,
                  int F, int M, int D, int DC, int NC, cudaStream_t stream) {
  if (F < 1 || D < 1 || M < 1 || M > MAX_TILES * TM || DC < 16 ||
      DC % 16 || (long)NC * DC < D)
    return (int)cudaErrorInvalidValue;
  int dev, smem_max, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int nt = (M + TM - 1) / TM, npairs = nt * (nt + 1) / 2;
  int ring = MAX_RING;                   // as deep a ring as fits
  while (ring >= 2 && smem_bytes(nt, ring) > (size_t)smem_max) --ring;
  if (ring < 2) return (int)cudaErrorInvalidValue;
  float2* Cb = static_cast<float2*>(cbuf);
  quad_form_pack_kernel<<<dim3(npairs, F), 256, 0, stream>>>(
      static_cast<const float2*>(P), Cb, M, nt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(nt, ring);
  e = cudaFuncSetAttribute(quad_form_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  // items of a bin: the sub-items of each chunk that start below D
  const int spc = (DC + DT - 1) / DT;
  int ni = 0;
  while (ni < NC * spc && (ni / spc) * DC + (ni % spc) * DT < D) ++ni;
  const long items = (long)F * ni;
  const int grid = (int)(items < sms ? items : sms);
  quad_form_kernel<<<grid, NTH, smem, stream>>>(
      Cb, static_cast<const float2*>(Pt), out, F, M, D, DC, spc, ni, ring);
  return (int)cudaGetLastError();
}

const char* zrt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
