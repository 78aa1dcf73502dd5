// Backward of the grouped (per-expert) matrix product for Hopper (sm_90a):
// the two gradients of out[e] = x[e] @ w[e] (moe_gmm.cu) that MoE training
// needs.
//
// Replaces: no TPU kernel.  The Pallas `moe_gmm_kernel`
// (src/repro/kernels/moe_gmm/moe_gmm.py:39) is forward only, and the
// reference differentiates the XLA einsums of its expert FFN
// (src/repro/models/moe.py:64-73).  Same function as their transpose:
// given x (E, C, K), w (E, K, F), the cotangent dy (E, C, F) and an
// optional counts (E,) int32 (the rows each expert holds),
//   dx[e] = dy[e] @ w[e]^T  (E, C, K), rows from counts[e] on written as 0;
//   dw[e] = x[e]^T @ dy[e]  (E, K, F), summed over rows below counts[e];
// each summed in fp32 and rounded once to the inputs' dtype.
//
// What bounds it on the H100: at the training shapes (deepseek-moe-16b,
// 8,192 tokens, C = 960 rows per expert) each product is 2 E C K F = 354
// GFLOP against ~0.8 GB of bf16 operands, ~440 flops per byte, above the
// ~295 where the tensor cores and not the memory are the limit: both
// products are bound by the operations.  Within the kernel what comes
// first is feeding the tensor cores: a 128 x 256 tile reads 85 flops per
// byte from L2, and with the products removed the copies alone take
// nearly the kernel's time.  So the threads that multiply do nothing
// else, the copies run ahead of them, and the walk keeps every block on
// the same expert so that its operands are read from L2, not from memory.
//
// Both products are one grouped GEMM, out[e] (M x N) = sum_r A(m, r) B(r, n):
//   dX: M = C, N = K, R = F; A(m, r) = dy[e][m][r], B(r, n) = w[e][n][r];
//   dW: M = K, N = F, R = C; A(m, r) = x[e][r][m],  B(r, n) = dy[e][r][n].
// `live` = min(C, counts[e]): dX's output rows from live on are zeros and
// its tiles wholly past live read nothing; dW's reduction runs over rows
// below live only, so an expert with no row writes zeros.
//
// Two instances, picked by the wrapper from dtype and shape:
//
// * `gmm_bwd_tc`, bf16 with K and F multiples of 8 and 16-byte aligned
//   operands (exactly what TMA asks of a tensor: 16-byte aligned base and
//   row strides).  One persistent launch, one block per SM, walks the 128 x
//   256 output tiles of both products (`walk_next`: rounds of one tile per
//   block, each round of one kind of tile, taken in expert order).  A
//   block is three warpgroups.  The producer (its registers cut to 40 by
//   `setmaxnreg`) has one thread that issues TMA copies of 64-deep
//   reduction stages of both operands into a 4-stage ring of 48 KB slots,
//   each slot with a full / empty `mbarrier` pair; it runs ahead into the
//   next tile, so one tile's epilogue overlaps the next one's loads.  Two
//   consumer warpgroups (232 registers) each own 64 rows x 256 columns of
//   fp32 accumulators and issue `wgmma` m64n256k16 from shared memory,
//   keeping one stage's products in flight while the next stage's are
//   issued; they round the tile to bf16 into a swizzled shared buffer and
//   TMA stores it.  dX reads dy and w along F, the contiguous axis of both
//   (K-major operands: w keeps its (K, F) layout, no transposed copy); dW
//   reads x and dy across their rows (MN-major, wgmma's transpose bits).
//   Each operand has a 3-D tensor map over (expert, rows, columns) with a
//   128-byte swizzle, so the copy zero-fills each expert's ragged edges
//   itself.  In dW's stage that straddles `live`, the consumers zero the
//   dy rows from live on in shared memory and fence them to the async
//   proxy before the wgmma reads them.
// * `gmm_bwd_cc<T, kDW>`, fp32 (and bf16 of other shapes) on the CUDA
//   cores, exact fp32 FMAs: one block per (64 x 64 output tile, expert), a
//   loop over the reduction in steps of 32 staged in shared memory as fp32,
//   an 8 x 4 register tile per thread.
//
// No atomics and no reduction split across blocks: each output element is
// summed by one thread (one warpgroup's wgmma chain) in the order of the
// reduction index, so two calls are bit-identical.
#include <algorithm>
#include <climits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// --- the CUDA-core instance -------------------------------------------------

constexpr int kBM = 64;                  // output rows per block
constexpr int kBN = 64;                  // output columns per block
constexpr int kBR = 32;                  // depth of one staged reduction step
constexpr int kTR = 8;                   // rows per thread
constexpr int kTC = 4;                   // columns per thread
constexpr int kThreads = (kBM / kTR) * (kBN / kTC);   // 128
constexpr int kAStride = kBM + 4;        // keeps float4 reads aligned
constexpr int kALoads = kBM * kBR / kThreads;
constexpr int kBLoads = kBR * kBN / kThreads;
static_assert(kBM * kBR % kThreads == 0 && kBR * kBN % kThreads == 0,
              "tiles must split evenly over the threads");

template <typename T, bool kDW>
__global__ void __launch_bounds__(kThreads)
gmm_bwd_cc(const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ out, const int* __restrict__ counts, int C, int M,
           int N, int R) {
  __shared__ __align__(16) float As[kBR][kAStride];   // As[r][m]
  __shared__ __align__(16) float Bs[kBR][kBN];        // Bs[r][n]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int live = counts ? min(C, counts[e]) : C;
  const int m_end = kDW ? M : live;      // output rows that hold data
  const int r_end = kDW ? live : R;      // the reduction's extent
  const T* ae = a + static_cast<size_t>(e) * M * R;
  const T* be = b + static_cast<size_t>(e) * N * R;
  T* oe = out + static_cast<size_t>(e) * M * N;

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTC);      // column group
  const int ty = tid / (kBN / kTC);      // row group
  const bool rows_live = m0 + ty * kTR < m_end;

  float acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;

  // a tile with no live row reads nothing (block-uniform condition)
  for (int r0 = 0; m0 < m_end && r0 < r_end; r0 += kBR) {
    // consecutive threads walk each operand's contiguous dimension
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int idx = i * kThreads + tid;
      const int mm = kDW ? idx % kBM : idx / kBR;
      const int rr = kDW ? idx / kBM : idx % kBR;
      const int gm = m0 + mm, gr = r0 + rr;
      const size_t off = kDW ? static_cast<size_t>(gr) * M + gm
                             : static_cast<size_t>(gm) * R + gr;
      As[rr][mm] = (gm < m_end && gr < r_end) ? repro::to_f32(ae[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int idx = i * kThreads + tid;
      const int nn = kDW ? idx % kBN : idx / kBR;
      const int rr = kDW ? idx / kBN : idx % kBR;
      const int gn = n0 + nn, gr = r0 + rr;
      const size_t off = kDW ? static_cast<size_t>(gr) * N + gn
                             : static_cast<size_t>(gn) * R + gr;
      Bs[rr][nn] = (gn < N && gr < r_end) ? repro::to_f32(be[off]) : 0.f;
    }
    __syncthreads();
    if (rows_live) {
#pragma unroll 8
      for (int rr = 0; rr < kBR; ++rr) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[rr][ty * kTR]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[rr][ty * kTR + 4]);
        const float4 bv4 = *reinterpret_cast<const float4*>(&Bs[rr][tx * kTC]);
        const float av[kTR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kTC] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // rows past m_end keep acc = 0: dX writes them as zeros
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int gm = m0 + ty * kTR + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int gn = n0 + tx * kTC + j;
      if (gn < N)
        oe[static_cast<size_t>(gm) * N + gn] = repro::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool kDW>
int launch_cc(const void* a, const void* b, void* out, const int* counts,
              int E, int C, int M, int N, int R, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  gmm_bwd_cc<T, kDW><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      counts, C, M, N, R);
  return (int)cudaGetLastError();
}

// --- the tensor-core instance (bf16) ----------------------------------------

// A timing build may compile this file with -DREPRO_GMM_BWD_PARTS=1 (dX's
// tiles alone) or 2 (dW's alone), the other output left unwritten, to time
// the two products apart; the package's build walks both.
#ifndef REPRO_GMM_BWD_PARTS
#define REPRO_GMM_BWD_PARTS 3
#endif

namespace tc {
constexpr int kBM = 128;                 // output rows of a tile
constexpr int kBN = 256;                 // output columns of a tile
constexpr int kBR = 64;                  // reduction depth of one ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups of 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);    // and the producer
constexpr int kLine = 128;               // bytes of one swizzled line
constexpr int kAtom = 64 * kLine;        // a 64 x 64 box of bf16, 8 KB
constexpr int kABytes = kBM * kBR * 2;   // 16 KB
constexpr int kBBytes = kBN * kBR * 2;   // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = 2 * kAtom;     // a consumer's output buffer: 64
                                         // rows x 128 columns
constexpr int kLiveCache = 256;          // experts whose live rows are
                                         // kept in shared memory
constexpr int kSmem = kStages * kStageBytes + kConsumers * kOutBytes +
                      2 * kStages * 8 + kLiveCache * 4 + 1024;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kDX = 1, kDW = 2;          // the products a launch walks:
constexpr int kParts = REPRO_GMM_BWD_PARTS;   // both, unless a timing build
                                              // sets one alone
static_assert(kParts >= 1 && kParts <= (kDX | kDW), "kDX, kDW or both");
static_assert(kBM == 64 * kConsumers && kBN == 256 && kBR == 64,
              "each consumer warpgroup owns one m64n256 slab");
static_assert(kSmem <= 232448, "a block's shared memory on the H100");
}  // namespace tc

struct BwdParams {
  const int* counts;                     // null: every expert holds C rows
  const int* live;                       // min(C, counts) of the first
                                         // kLiveCache experts (shared
                                         // memory, set in the kernel)
  int E, C, K, F;
  int mt_dx, nt_dx, mt_dw, nt_dw;        // tile rows and columns of each
  int tiles;                             // the walk's length
};

// One tile of the walk.
struct Tile {
  bool dw;
  int e, m0, n0;
  int M, N;                              // the product's output extent
  int live;                              // the expert's rows below count
  int nk;                                // ring stages it reads (0: none)
};

// The walk.  Tiles fall in three classes: dX tiles holding a live row
// (each reads all of F), dW tiles (each reads the expert's live rows) and
// dX tiles wholly past `live` (they read nothing and write zeros); within
// a class, experts in order, and within an expert, row-major over the
// tiles.  The walk is a sequence of rounds of gridDim.x tiles, block b
// taking the round's b-th; a round holds one class only, so its tiles
// cost about the same and no block runs ahead of the others.  Each round
// takes the next tiles of whichever of the first two classes is behind in
// the expert order, so the blocks work on about one expert at a time and
// its x, dy and w stay in L2; the zero tiles come last.  Every thread that
// walks (the producer's and the consumers') computes the same rounds from
// the counts: no atomics, the same tiles on every call.
struct Cursor {
  int e, i;                              // expert, index within it
};
struct Walk {
  Cursor x, d, z;                        // each class's next tile
};

__device__ __forceinline__ int live_rows_global(const BwdParams& p, int e) {
  return p.counts ? max(0, min(p.C, __ldg(p.counts + e))) : p.C;
}

// the walk reads these many times a tile: from shared memory where cached
__device__ __forceinline__ int live_rows(const BwdParams& p, int e) {
  return e < tc::kLiveCache ? p.live[e] : live_rows_global(p, e);
}

// tiles of expert e in class `cls` (0: live dX, 1: dW, 2: zero dX)
__device__ __forceinline__ int class_len(const BwdParams& p, int cls, int e) {
  if (cls == 1) return tc::kParts & tc::kDW ? p.mt_dw * p.nt_dw : 0;
  if (!(tc::kParts & tc::kDX)) return 0;
  const int lt = (live_rows(p, e) + tc::kBM - 1) / tc::kBM;
  return (cls == 0 ? lt : p.mt_dx - lt) * p.nt_dx;
}

// move a class cursor n tiles on (n = 0: onto its next tile); e == E
// when the class is used up
__device__ __forceinline__ void advance(const BwdParams& p, int cls,
                                        Cursor& c, int n) {
  for (; c.e < p.E; ++c.e, c.i = 0) {
    const int len = class_len(p, cls, c.e);
    if (c.i + n < len) {
      c.i += n;
      return;
    }
    n -= max(0, len - c.i);
  }
}

__device__ __forceinline__ Walk walk_start(const BwdParams& p) {
  Walk w{{0, 0}, {0, 0}, {0, 0}};
  advance(p, 0, w.x, 0);
  advance(p, 1, w.d, 0);
  advance(p, 2, w.z, 0);
  return w;
}

// The tile at (class, expert, index within the expert).
__device__ __forceinline__ Tile tile_of(const BwdParams& p, int cls, int e,
                                        int i) {
  Tile u;
  u.dw = cls == 1;
  u.e = e;
  u.live = live_rows(p, e);
  const int nt = u.dw ? p.nt_dw : p.nt_dx;
  const int m_first = cls == 2 ? (u.live + tc::kBM - 1) / tc::kBM : 0;
  u.m0 = (m_first + i / nt) * tc::kBM;
  u.n0 = i % nt * tc::kBN;
  u.M = u.dw ? p.K : p.C;
  u.N = u.dw ? p.F : p.K;
  if (cls == 0)
    u.nk = (p.F + tc::kBR - 1) / tc::kBR;
  else
    u.nk = u.dw ? (u.live + tc::kBR - 1) / tc::kBR : 0;
  return u;
}

// This block's next tile; false once the walk is done.  (The cursors are
// picked by value, not indexed, so they stay in registers.)
__device__ __forceinline__ bool walk_next(const BwdParams& p, Walk& w,
                                          Tile& u) {
  for (;;) {
    int cls = 2;
    const bool x_left = w.x.e < p.E, d_left = w.d.e < p.E;
    if (x_left && d_left) {
      // the class whose next tile sits earlier in the expert order
      const int lx = class_len(p, 0, w.x.e), ld = class_len(p, 1, w.d.e);
      cls = w.x.e < w.d.e || (w.x.e == w.d.e && w.x.i * ld <= w.d.i * lx)
                ? 0
                : 1;
    } else if (x_left || d_left) {
      cls = x_left ? 0 : 1;
    } else if (w.z.e >= p.E) {
      return false;
    }
    Cursor c = cls == 0 ? w.x : cls == 1 ? w.d : w.z;
    Cursor mine = c;
    advance(p, cls, mine, blockIdx.x);
    advance(p, cls, c, gridDim.x);
    if (cls == 0)
      w.x = c;
    else if (cls == 1)
      w.d = c;
    else
      w.z = c;
    if (mine.e < p.E) {
      u = tile_of(p, cls, mine.e, mine.i);
      return true;
    }
  }
}

// The ring stages of one tile for one consumer warpgroup (`cw`): wait for
// each, multiply its 64-row slab of A by all of B (four k16 steps), and
// release the stage once the products of the next one are issued.  The
// wgmma calls sit on no data-dependent branch of their own (one there
// makes ptxas serialise them): the product is a template parameter, a
// warpgroup with no live row skips whole stages, and dW's stage past
// `live` is zero-filled rather than cut short.
template <bool kDWTile>
__device__ __forceinline__ void consume_tile(const Tile& u, float (&acc)[128],
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int& it, int cw) {
  using namespace repro::sm90;
  constexpr int kStages = tc::kStages, kBR = tc::kBR, kAtom = tc::kAtom;
  const int lane = threadIdx.x % 32;
  // a slab of dX rows all at or past `live` (or of dW rows past K)
  // multiplies nothing: it waits for and releases the stages with the
  // other warpgroup, and its tile is written as zeros
  const bool active = u.m0 + 64 * cw < (kDWTile ? u.M : u.live);
  int held = -1;                         // the slot still being read
  for (int k = 0; k < u.nk; ++k, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const unsigned char* a = ring + s * tc::kStageBytes + cw * kAtom;
    unsigned char* b = ring + s * tc::kStageBytes + tc::kABytes;
    const int rem = u.live - k * kBR;
    if (kDWTile && rem < kBR) {
      // the stage that straddles `live`: zero dy's rows rem .. 63 in all
      // four boxes (a line is one row, 8 chunks of 16 bytes), then hand
      // them to the async proxy before the wgmma reads them
      const int chunks = (kBR - rem) * (tc::kBBytes / kAtom) * 8;
      for (int i = threadIdx.x - 128; i < chunks; i += 128 * tc::kConsumers)
        *reinterpret_cast<uint4*>(b + (i / 8 % 4) * kAtom +
                                  (rem + i / 32) * tc::kLine + i % 8 * 16) =
            make_uint4(0, 0, 0, 0);
      fence_proxy_async_smem();
      named_barrier(1, 128 * tc::kConsumers);
    }
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBR / 16; ++kk) {
        if constexpr (kDWTile) {         // MN-major: 16 lines a step
          wgmma_m64n256k16<1, 1>(
              acc, desc_sw128(a + kk * 16 * tc::kLine, kAtom, 1024),
              desc_sw128(b + kk * 16 * tc::kLine, kAtom, 1024));
        } else {                         // K-major: 32 bytes a step
          wgmma_m64n256k16<0, 0>(acc, desc_sw128(a + kk * 32, 16, 1024),
                                 desc_sw128(b + kk * 32, 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();                   // the previous stage's are done
      fence_operands(acc);
    }
    if (held >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[held]);
    }
    held = s;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (held >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[held]);
  }
}

// The epilogue of one consumer warpgroup: its 64 x 256 slab rounded to
// bf16 (dX rows at or past `live` as zeros) goes through its 16 KB buffer
// in two halves of two swizzled 64 x 64 boxes, each half stored by TMA,
// which drops what lies outside the output.  The stores run on while the
// warpgroup starts the next tile; a half waits only until the previous
// store has read the buffer.
__device__ __forceinline__ void store_tile(const Tile& u,
                                           const float (&acc)[128],
                                           unsigned char* buf,
                                           const CUtensorMap* map, int cw) {
  using namespace repro::sm90;
  const int row0 = u.m0 + 64 * cw;
  if (row0 >= u.M) return;               // the slab lies past the output
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (leader) bulk_wait_read<0>();
    named_barrier(2 + cw, 128);          // the buffer is free
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + lane / 4 + 8 * h;   // row of the slab
      const bool zero = !u.dw && row0 + r >= u.live;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * half + jj;    // the n8 block
        *reinterpret_cast<uint32_t*>(
            buf + jj / 8 * tc::kAtom + r * tc::kLine +
            ((jj % 8) ^ (r % 8)) * 16 + lane % 4 * 4) =
            zero ? 0u
                 : repro::pack_bf16x2(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
      }
    }
    fence_proxy_async_smem();
    named_barrier(2 + cw, 128);          // the half is written
    if (leader) {
      for (int box = 0; box < 2; ++box) {
        const int n = u.n0 + 128 * half + 64 * box;
        if (n < u.N)
          tma_store_3d(map, buf + box * tc::kAtom, n, row0, u.e);
      }
      bulk_commit();
    }
  }
}

// Tensor maps (all bf16, 128-byte swizzle, boxes of 64 values along the
// contiguous axis):
//   dy_k  dy (E, C, F), box 128 rows of C: dX's A;
//   w_k   w  (E, K, F), box 256 rows of K: dX's B;
//   x_mn  x  (E, C, K), box 64 rows of C:  dW's A, two boxes along K;
//   dy_mn dy (E, C, F), box 64 rows of C:  dW's B, four boxes along F;
//   dx_o  dx (E, C, K) and dw_o dw (E, K, F), boxes of 64 rows: the
//   outputs.
__global__ void __launch_bounds__(tc::kThreads, 1)
gmm_bwd_tc(const __grid_constant__ CUtensorMap dy_k,
           const __grid_constant__ CUtensorMap w_k,
           const __grid_constant__ CUtensorMap x_mn,
           const __grid_constant__ CUtensorMap dy_mn,
           const __grid_constant__ CUtensorMap dx_o,
           const __grid_constant__ CUtensorMap dw_o, BwdParams p) {
  using namespace repro::sm90;
  constexpr int kStages = tc::kStages, kBR = tc::kBR, kAtom = tc::kAtom;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) &
                                    1023);
  unsigned char* out_bufs = ring + kStages * tc::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      out_bufs + tc::kConsumers * tc::kOutBytes);
  uint64_t* empty = full + kStages;
  int* live = reinterpret_cast<int*>(empty + kStages);
  for (int e = threadIdx.x; e < min(p.E, tc::kLiveCache); e += blockDim.x)
    live[e] = live_rows_global(p, e);
  p.live = live;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                       // the producer's
      mbar_init(&empty[s], 4 * tc::kConsumers);     // each consumer warp's
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {               // the producer warpgroup
    setmaxnreg_dec<tc::kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&dy_k);
      prefetch_tensor_map(&w_k);
      prefetch_tensor_map(&x_mn);
      prefetch_tensor_map(&dy_mn);
      int it = 0;                        // stages issued by this block
      Walk wk = walk_start(p);
      Tile u;
      while (walk_next(p, wk, u)) {
        for (int k = 0; k < u.nk; ++k, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          unsigned char* a = ring + s * tc::kStageBytes;
          unsigned char* b = a + tc::kABytes;
          if (u.dw) {
            // a box wholly past M (N) feeds only output rows (columns)
            // that are not written: it is not copied
            const int na = min(tc::kBM / 64, (u.M - u.m0 + 63) / 64);
            const int nb = min(tc::kBN / 64, (u.N - u.n0 + 63) / 64);
            mbar_arrive_expect_tx(&full[s], (na + nb) * kAtom);
            for (int j = 0; j < na; ++j)
              tma_load_3d(a + j * kAtom, &x_mn, &full[s], u.m0 + 64 * j,
                          k * kBR, u.e);
            for (int j = 0; j < nb; ++j)
              tma_load_3d(b + j * kAtom, &dy_mn, &full[s], u.n0 + 64 * j,
                          k * kBR, u.e);
          } else {
            mbar_arrive_expect_tx(&full[s], tc::kStageBytes);
            tma_load_3d(a, &dy_k, &full[s], k * kBR, u.m0, u.e);
            tma_load_3d(b, &w_k, &full[s], k * kBR, u.n0, u.e);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  setmaxnreg_inc<tc::kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;  // which 64 rows of the tile
  unsigned char* buf = out_bufs + cw * tc::kOutBytes;
  float acc[128];
  int it = 0;                            // stages consumed by this block
  Walk wk = walk_start(p);
  Tile u;
  while (walk_next(p, wk, u)) {
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    if (u.dw) {
      consume_tile<true>(u, acc, ring, full, empty, it, cw);
      store_tile(u, acc, buf, &dw_o, cw);
    } else {
      consume_tile<false>(u, acc, ring, full, empty, it, cw);
      store_tile(u, acc, buf, &dx_o, cw);
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait<0>();   // the last stores landed
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tile walk of one launch; false if the shape is out of range (the
// walk's length must fit an int).
bool plan_tc(int E, int C, int K, int F, BwdParams* p) {
  if (E < 1 || C < 1 || K < 1 || F < 1) return false;
  p->E = E;
  p->C = C;
  p->K = K;
  p->F = F;
  p->mt_dx = cdiv(C, tc::kBM);
  p->nt_dx = cdiv(K, tc::kBN);
  p->mt_dw = cdiv(K, tc::kBM);
  p->nt_dw = cdiv(F, tc::kBN);
  const long long per =
      (tc::kParts & tc::kDX ? static_cast<long long>(p->mt_dx) * p->nt_dx
                            : 0) +
      (tc::kParts & tc::kDW ? static_cast<long long>(p->mt_dw) * p->nt_dw
                            : 0);
  if (E * per > INT_MAX) return false;
  p->tiles = static_cast<int>(E * per);
  return true;
}

// a 3-D map over a contiguous bf16 (E, rows, cols) tensor, boxes of
// (64 columns, box_rows rows, one expert), 128-byte swizzle; what lies
// outside the tensor reads as zeros and is not written
bool encode(CUtensorMap* map, const void* base, int E, int rows, int cols,
            int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = repro::sm90::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current device's SM count, read once per device
int sm_count(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return repro::kUnsupported;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *out = cached[dev];
  return 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_tc(const void* x, const void* w, const void* dy, void* dx,
              void* dw, const int* counts, int E, int C, int K, int F,
              cudaStream_t stream) {
  BwdParams p;
  if (!plan_tc(E, C, K, F, &p) || K % 8 || F % 8 || !aligned16(x) ||
      !aligned16(w) || !aligned16(dy) || !aligned16(dx) || !aligned16(dw))
    return repro::kUnsupported;
  p.counts = counts;
  CUtensorMap dy_k, w_k, x_mn, dy_mn, dx_o, dw_o;
  if (!encode(&dy_k, dy, E, C, F, tc::kBM) ||
      !encode(&w_k, w, E, K, F, tc::kBN) ||
      !encode(&x_mn, x, E, C, K, 64) || !encode(&dy_mn, dy, E, C, F, 64) ||
      !encode(&dx_o, dx, E, C, K, 64) || !encode(&dw_o, dw, E, K, F, 64))
    return repro::kTensorMapRefused;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmem);
  if (err != cudaSuccess) return (int)err;
  gmm_bwd_tc<<<std::min(sms, p.tiles), tc::kThreads, tc::kSmem, stream>>>(
      dy_k, w_k, x_mn, dy_mn, dx_o, dw_o, p);
  return (int)cudaGetLastError();
}

bool dims_fit(int E, int C, int K, int F) {
  return E >= 1 && E <= 65535 && C >= 1 && K >= 1 && F >= 1 &&
         (C + kBM - 1) / kBM <= 65535 && (K + kBM - 1) / kBM <= 65535;
}

}  // namespace

// C entry points (ctypes).  x (E, C, K), w (E, K, F), dy (E, C, F), and the
// outputs dx (E, C, K) and dw (E, K, F) must be contiguous and share one
// dtype; `counts` is null or (E,) int32 on the same device.  Each launches
// on `stream` and returns 0 on success, the cudaError_t of a refused
// launch, kUnsupported (-1) for a shape or dtype the instance does not
// take, or kTensorMapRefused (-2) when the driver refuses a TMA map.

// the CUDA-core instance: fp32 or bf16, any shape; dX's kernel, then dW's
extern "C" int repro_moe_gmm_bwd(const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, const void* counts,
                                 int E, int C, int K, int F, int dtype,
                                 void* stream) {
  if (!dims_fit(E, C, K, F)) return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  int rc;
  if (dtype == repro::kF32) {
    rc = launch_cc<float, false>(dy, w, dx, cn, E, C, C, K, F, st);
    return rc ? rc : launch_cc<float, true>(x, dy, dw, cn, E, C, K, F, C, st);
  }
  if (dtype == repro::kBF16) {
    rc = launch_cc<bf16, false>(dy, w, dx, cn, E, C, C, K, F, st);
    return rc ? rc : launch_cc<bf16, true>(x, dy, dw, cn, E, C, K, F, C, st);
  }
  return repro::kUnsupported;
}

// the tensor-core instance: bf16, K and F multiples of 8, every operand
// 16-byte aligned; one launch for dX and dW
extern "C" int repro_moe_gmm_bwd_tc(const void* x, const void* w,
                                    const void* dy, void* dx, void* dw,
                                    const void* counts, int E, int C, int K,
                                    int F, void* stream) {
  return launch_tc(x, w, dy, dx, dw, static_cast<const int*>(counts), E, C,
                   K, F, static_cast<cudaStream_t>(stream));
}
