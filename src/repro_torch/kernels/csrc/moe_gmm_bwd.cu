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
// products are bound by the operations.
//
// Both products are one grouped GEMM, out[e] (M x N) = sum_r A(m, r) B(r, n):
//   dX: M = C, N = K, R = F; A(m, r) = dy[e][m][r], B(r, n) = w[e][n][r];
//   dW: M = K, N = F, R = C; A(m, r) = x[e][r][m],  B(r, n) = dy[e][r][n].
// `live` = min(C, counts[e]): dX's output rows from live on are zeros and
// its blocks wholly past live read nothing; dW's reduction runs over rows
// below live only, rounded up to whole 16-row steps and zero-filled, so an
// expert with no row writes zeros.
//
// Two instances, picked by the wrapper from dtype and shape:
//
// * `gmm_bwd_tc<kDW>`, bf16 with K and F multiples of 8 and 16-byte aligned
//   operands: one block per (128 x 128 output tile, expert), eight warps as
//   2 x 4, each owning 64 x 32 (four m16 by four n8 tiles of mma.sync
//   m16n8k16, fp32 accumulators).  A three-stage cp.async ring stages
//   64-deep reduction steps of both operands (16 KB each) in XOR-swizzled
//   shared memory while the tensor cores consume the step before.  dX reads
//   dy and w along F, the reduction dimension and their contiguous one, so
//   both fragments load through plain ldmatrix: w keeps its (K, F) layout
//   and no transposed copy is made.  dW reads x and dy along C, across
//   their rows, so both load through ldmatrix.trans.  Ragged M and N edges
//   and rows past counts[e] are zero-filled by the copy itself.
// * `gmm_bwd_cc<T, kDW>`, fp32 (and bf16 of other shapes) on the CUDA
//   cores, exact fp32 FMAs: one block per (64 x 64 output tile, expert), a
//   loop over the reduction in steps of 32 staged in shared memory as fp32,
//   an 8 x 4 register tile per thread.
//
// No atomics and no reduction split across blocks: each output element is
// summed by one thread in the order of the reduction index, so two calls
// are bit-identical.
#include "common.cuh"
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

namespace tc {
constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBR = 64;                  // reduction depth of one ring stage
constexpr int kStages = 3;
constexpr int kWarpsN = 4;               // warps: 2 along M x 4 along N
constexpr int kThreads = 256;
constexpr int kMT = 4;                   // a warp's m16 tiles (64 rows)
constexpr int kNT = 4;                   // a warp's n8 tiles (32 columns)
constexpr int kTileBytes = kBM * kBR * 2;            // 16 KB per operand
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmem = kStages * kStageBytes;         // 96 KB
constexpr int kChunks = kTileBytes / 16 / kThreads;  // 16-byte copies each
static_assert(kThreads / 32 / kWarpsN * kMT * 16 == kBM &&
              kWarpsN * kNT * 8 == kBN, "the warps must cover the tile");
static_assert(kTileBytes % (16 * kThreads) == 0, "tiles split evenly");
}  // namespace tc

// Shared-memory tiles of one stage (16-byte chunks, swizzled by `swz`):
//   dX: A and B both 128 rows (m or n) x 8 chunks (64 reduction steps r);
//   dW: A and B both 64 rows (r) x 16 chunks (128 columns, m or n).
template <bool kDW>
__global__ void __launch_bounds__(tc::kThreads, 2)
gmm_bwd_tc(const bf16* __restrict__ a, const bf16* __restrict__ b,
           bf16* __restrict__ out, const int* __restrict__ counts, int C,
           int M, int N, int R) {
  constexpr int kBR = tc::kBR, kStages = tc::kStages;
  constexpr int kThreads = tc::kThreads, kTileBytes = tc::kTileBytes;
  constexpr int kStageBytes = tc::kStageBytes;
  constexpr int kMT = tc::kMT, kNT = tc::kNT;
  constexpr int kRowChunks = kDW ? 16 : 8;
  extern __shared__ __align__(128) unsigned char smem[];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * tc::kBM;
  const int n0 = blockIdx.x * tc::kBN;
  const int live = counts ? min(C, counts[e]) : C;
  const int m_end = kDW ? M : live;      // output rows that hold data
  const int r_end = kDW ? live : R;      // the reduction's extent
  const int nk = m0 < m_end ? (r_end + kBR - 1) / kBR : 0;   // 0: no read
  const bf16* ae = a + static_cast<size_t>(e) * M * R;
  const bf16* be = b + static_cast<size_t>(e) * N * R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / tc::kWarpsN, wn = warp % tc::kWarpsN;
  const repro::FragLane fa = repro::frag_lane_a(lane);
  const repro::FragLane fb = repro::frag_lane_b(lane);

  // one ring stage: both operands' 64-deep slices at reduction step kt
  auto load = [&](int stage, int kt) {
    unsigned char* as = smem + stage * kStageBytes;
    unsigned char* bs = as + kTileBytes;
    const int r0 = kt * kBR;
#pragma unroll
    for (int j = 0; j < tc::kChunks; ++j) {
      const int i = j * kThreads + tid;
      const int row = i / kRowChunks, c = i % kRowChunks;
      bool ina, inb;
      const bf16 *sa, *sb;
      if constexpr (kDW) {                // row = r, chunk along m / n
        const int r = r0 + row;
        ina = r < r_end && m0 + c * 8 < M;
        inb = r < r_end && n0 + c * 8 < N;
        sa = ae + static_cast<size_t>(r) * M + m0 + c * 8;
        sb = be + static_cast<size_t>(r) * N + n0 + c * 8;
      } else {                            // row = m / n, chunk along r
        const int r = r0 + c * 8;
        ina = m0 + row < m_end && r < r_end;
        inb = n0 + row < N && r < r_end;
        sa = ae + static_cast<size_t>(m0 + row) * R + r;
        sb = be + static_cast<size_t>(n0 + row) * R + r;
      }
      repro::cp_async_16(as + repro::swz(row, c, kRowChunks), ina ? sa : a,
                         ina ? 16 : 0);
      repro::cp_async_16(bs + repro::swz(row, c, kRowChunks), inb ? sb : b,
                         inb ? 16 : 0);
    }
  };

  float acc[kMT][kNT][4];                // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    repro::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    repro::cp_async_wait<kStages - 2>();   // stage kt has landed
    __syncthreads();                       // ... for every thread, and the
                                           // stage read at kt - 1 is free
    if (kt + kStages - 1 < nk)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    repro::cp_async_commit();

    const unsigned char* as = smem + (kt % kStages) * kStageBytes;
    const unsigned char* bs = as + kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBR / 16; ++kk) {
      // dW: a 16-row step wholly past the live rows adds only zeros
      if (kDW && kt * kBR + kk * 16 >= r_end) continue;
      uint32_t bfr[kNT][2];              // the warp's n8 tiles
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        const int n = wn * kNT * 8 + j * 16;
        uint32_t r[4];
        if constexpr (kDW)
          repro::ldmatrix_x4_trans(
              r, bs + repro::swz_frag(fa, kk * 16, n / 8, kRowChunks));
        else
          repro::ldmatrix_x4(
              r, bs + repro::swz_frag(fb, n, kk * 2, kRowChunks));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int m = wm * kMT * 16 + mt * 16;
        // dX: an m16 tile wholly past the live rows stays zero
        if (!kDW && m0 + m >= m_end) continue;
        uint32_t afr[4];
        if constexpr (kDW)
          repro::ldmatrix_x4_trans(
              afr, as + repro::swz_frag(fb, kk * 16, m / 8, kRowChunks));
        else
          repro::ldmatrix_x4(
              afr, as + repro::swz_frag(fa, m, kk * 2, kRowChunks));
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          repro::mma_bf16(acc[mt][nt], afr, bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  // every row of the tile is written; dX rows past `live` hold zeros
  bf16* oe = out + static_cast<size_t>(e) * M * N;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * kMT * 16 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = n0 + wn * kNT * 8 + nt * 8 + 2 * t;
        if (col < N)
          *reinterpret_cast<uint32_t*>(oe + static_cast<size_t>(row) * N +
                                       col) =
              repro::pack_bf16x2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <bool kDW>
int launch_tc(const void* a, const void* b, void* out, const int* counts,
              int E, int C, int M, int N, int R, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bwd_tc<kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + tc::kBN - 1) / tc::kBN, (M + tc::kBM - 1) / tc::kBM, E);
  gmm_bwd_tc<kDW><<<grid, tc::kThreads, tc::kSmem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), counts, C, M, N, R);
  return (int)cudaGetLastError();
}

bool dims_fit(int E, int C, int K, int F) {
  return E >= 1 && E <= 65535 && C >= 1 && K >= 1 && F >= 1 &&
         (C + kBM - 1) / kBM <= 65535 && (K + kBM - 1) / kBM <= 65535;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C entry points (ctypes).  x (E, C, K), w (E, K, F), dy (E, C, F), and the
// outputs dx (E, C, K) and dw (E, K, F) must be contiguous and share one
// dtype; `counts` is null or (E,) int32 on the same device.  Each launches
// dX, then dW, on `stream`, and returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a shape or dtype the instance does not take.

// the CUDA-core instance: fp32 or bf16, any shape
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
// 16-byte aligned
extern "C" int repro_moe_gmm_bwd_tc(const void* x, const void* w,
                                    const void* dy, void* dx, void* dw,
                                    const void* counts, int E, int C, int K,
                                    int F, void* stream) {
  if (!dims_fit(E, C, K, F) || K % 8 || F % 8 || !aligned16(x) ||
      !aligned16(w) || !aligned16(dy) || !aligned16(dx) || !aligned16(dw))
    return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  const int rc = launch_tc<false>(dy, w, dx, cn, E, C, C, K, F, st);
  return rc ? rc : launch_tc<true>(x, dy, dw, cn, E, C, K, F, C, st);
}
