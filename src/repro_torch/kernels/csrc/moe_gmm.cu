// Grouped (per-expert) matrix product for Hopper (sm_90a): the MoE expert
// FFN's three products over the capacity-dispatched layout.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py, `moe_gmm_kernel` (the
// Pallas TPU kernel, pl.pallas_call at :50).  Same function: x (E, C, K),
// w (E, K, F) -> out (E, C, F), out[e] = x[e] @ w[e], products summed in
// fp32, output in x's dtype.  Unlike the Pallas kernel, whose tiles must
// divide C, K and F (moe_gmm.py:47), both instances here mask ragged
// tiles: deepseek-moe-16b's wo product has K = 1408, which the Pallas
// kernel's default block_k of 512 does not divide.  An optional `counts`
// (E,) int32 gives the rows each expert holds; rows [counts[e], C) are
// zero in x, so they are neither read nor multiplied and their output
// rows are written as zeros: the same result as without `counts`.
//
// What bounds it on the H100: on the serving path C is small (24-48 rows
// per expert for deepseek-moe-16b), so each bf16 weight element feeds at
// most C multiply-adds, 24-48 flops per byte, far below the ~295 flops
// per byte where the tensor cores would be the limit: the bound is the
// weights' bytes.  With `counts`, only the experts that hold a row read
// their weights.
//
// Two instances, picked by the wrapper from dtype and shape:
//
// * `gmm_tc`, bf16 with K and F multiples of 8 (every row starts on 16
//   bytes): its only job is to stream the weights at the memory's rate.
//   One block per (128-column F tile, group of up to 64 rows, expert),
//   its rows C rounded up to whole m16 tiles (a template argument, so the
//   accumulators are exactly the live tiles' registers); eight warps each
//   own 16 columns (two n8 tiles) for every m16 tile, so the block reads
//   each weight byte once for all its rows.  A two-stage cp.async ring
//   loads the next 64-deep K step (the 64 x 128 W tile, 16 KB, and the x
//   slice) while the tensor cores (mma.sync m16n8k16, fp32 accumulators)
//   consume this one; fragments come from XOR-swizzled shared memory
//   through ldmatrix (transposed for W, which is (K, F) row-major), so
//   neither the async writes nor the fragment reads conflict on banks.
//   Ragged K and F edges and rows past counts[e] are zero-filled by the
//   copy itself; m16 tiles wholly past counts[e] skip their MMAs, and an
//   expert with no row never touches its weights.  The ring depth, the
//   warp count and the tile width were chosen on the H100 at deepseek's
//   shapes, where the grid (704-1024 blocks) against the two blocks an SM
//   holds sets how full the last wave is.
// * `grouped_matmul`, fp32 (and bf16 of other shapes) on the CUDA cores,
//   exact fp32 FMAs (TF32 would not meet the fp32 checks): one block per
//   (64-column F tile, 64-row C tile, expert), a loop over K in steps of
//   32 staging x (transposed, rows padded to 68 floats) and w in shared
//   memory as fp32, an 8 x 4 register tile per thread.  It is bound by
//   the fp32 operations and the per-step staging, not by the bytes.
//
// Both sum each output element in the order of k in registers, so the
// result does not depend on the launch and two calls are bit-identical.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// --- the CUDA-core instance -------------------------------------------------

constexpr int kBC = 64;                  // rows of x per block (C tile)
constexpr int kBF = 64;                  // columns of w per block (F tile)
constexpr int kBK = 32;                  // depth of one staged K step
constexpr int kTR = 8;                   // rows per thread
constexpr int kTC = 4;                   // columns per thread
constexpr int kThreads = (kBC / kTR) * (kBF / kTC);   // 128
constexpr int kXStride = kBC + 4;        // keeps float4 reads aligned
constexpr int kXLoads = kBC * kBK / kThreads;
constexpr int kWLoads = kBK * kBF / kThreads;
static_assert(kBC * kBK % kThreads == 0 && kBK * kBF % kThreads == 0,
              "tiles must split evenly over the threads");

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_matmul(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, const int* __restrict__ counts, int C,
               int K, int F) {
  __shared__ __align__(16) float Xs[kBK][kXStride];   // Xs[k][row]
  __shared__ __align__(16) float Ws[kBK][kBF];        // Ws[k][col]

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBC;
  const int f0 = blockIdx.x * kBF;
  const T* xe = x + static_cast<size_t>(e) * C * K;
  const T* we = w + static_cast<size_t>(e) * K * F;
  T* oe = out + static_cast<size_t>(e) * C * F;
  const int filled = counts ? min(C, counts[e]) : C;

  const int tid = threadIdx.x;
  const int tx = tid % (kBF / kTC);      // column group
  const int ty = tid / (kBF / kTC);      // row group
  const bool live = c0 + ty * kTR < filled;

  float acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;

  // a tile with no filled row reads nothing (block-uniform condition)
  for (int k0 = 0; c0 < filled && k0 < K; k0 += kBK) {
    // x tile: a warp reads 32 consecutive k of one row (coalesced)
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = i * kThreads + tid;
      const int r = idx / kBK, kk = idx % kBK;
      const int gr = c0 + r, gk = k0 + kk;
      Xs[kk][r] = (gr < filled && gk < K)
                      ? repro::to_f32(xe[static_cast<size_t>(gr) * K + gk])
                      : 0.f;
    }
    // w tile: a warp reads 32 consecutive columns of one k row
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = i * kThreads + tid;
      const int kk = idx / kBF, cc = idx % kBF;
      const int gk = k0 + kk, gf = f0 + cc;
      Ws[kk][cc] = (gk < K && gf < F)
                       ? repro::to_f32(we[static_cast<size_t>(gk) * F + gf])
                       : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * kTR]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&Xs[kk][ty * kTR + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Ws[kk][tx * kTC]);
        const float a[kTR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kTC] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j)
            acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // rows past `filled` keep acc = 0: they are written as zeros
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int gr = c0 + ty * kTR + i;
    if (gr >= C) break;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      const int gf = f0 + tx * kTC + j;
      if (gf < F)
        oe[static_cast<size_t>(gr) * F + gf] = repro::from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, const int* counts, int E,
           int C, int K, int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (C + kBC - 1) / kBC, E);
  grouped_matmul<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      counts, C, K, F);
  return (int)cudaGetLastError();
}

// --- the tensor-core instance (bf16) ----------------------------------------

namespace tc {
constexpr int kBN = 128;                 // F columns per block
constexpr int kBK = 64;                  // K depth of one ring stage
constexpr int kStages = 2;
constexpr int kWarpN8 = 2;               // n8 tiles per warp: 8 warps
constexpr int kThreads = kBN / (8 * kWarpN8) * 32;
constexpr int kXChunks = kBK / 8;        // 16-byte chunks per x row
constexpr int kWChunks = kBN / 8;        // 16-byte chunks per w row
constexpr int kWBytes = kBK * kBN * 2;   // 16 KB
static_assert(kBK * kWChunks % kThreads == 0, "w tile splits evenly");
static_assert(kXChunks % 8 == 0 && kWChunks % 8 == 0,
              "the swizzle needs rows of 8+ chunks");

// a block of MT m16 row tiles: x slice MT * 16 x 64, then the W tile
template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return MT * 16 * kBK * 2 + kWBytes;
}
}  // namespace tc

template <int MT>
__global__ void __launch_bounds__(tc::kThreads)
gmm_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
       bf16* __restrict__ out, const int* __restrict__ counts, int C, int K,
       int F) {
  constexpr int kBM = MT * 16, kBN = tc::kBN, kBK = tc::kBK;
  constexpr int NT = tc::kWarpN8;
  constexpr int kStages = tc::kStages, kThreads = tc::kThreads;
  constexpr int kXChunks = tc::kXChunks, kWChunks = tc::kWChunks;
  constexpr int kXBytes = kBM * kBK * 2;
  constexpr int kStageBytes = tc::stage_bytes<MT>();
  extern __shared__ __align__(128) unsigned char smem[];

  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBM;
  const int f0 = blockIdx.x * kBN;
  const int rows = min(kBM, C - r0);                 // rows of this group
  const int filled = counts ? counts[e] : C;
  const int live = max(0, min(rows, filled - r0));   // rows holding data
  const int n_mt = (live + 15) / 16;                 // m16 tiles to multiply
  const int nk = n_mt ? (K + kBK - 1) / kBK : 0;     // 0: weights untouched

  const bf16* xg = x + (static_cast<size_t>(e) * C + r0) * K;
  const bf16* we = w + static_cast<size_t>(e) * K * F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const repro::FragLane fa = repro::frag_lane_a(lane);

  // one ring stage: the live rows' x slice and the 64 x 128 W tile at k0
  auto load = [&](int stage, int kt) {
    unsigned char* xs = smem + stage * kStageBytes;
    unsigned char* ws = xs + kXBytes;
    const int k0 = kt * kBK;
    for (int i = tid; i < n_mt * 16 * kXChunks; i += kThreads) {
      const int r = i / kXChunks, c = i % kXChunks;
      const bool in = r < live && k0 + c * 8 < K;
      const bf16* src = in ? xg + static_cast<size_t>(r) * K + k0 + c * 8 : x;
      repro::cp_async_16(xs + repro::swz(r, c, kXChunks), src, in ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < kBK * kWChunks / kThreads; ++j) {
      const int i = j * kThreads + tid;
      const int r = i / kWChunks, c = i % kWChunks;
      const bool in = k0 + r < K && f0 + c * 8 < F;
      const bf16* src =
          in ? we + static_cast<size_t>(k0 + r) * F + f0 + c * 8 : w;
      repro::cp_async_16(ws + repro::swz(r, c, kWChunks), src, in ? 16 : 0);
    }
  };

  float acc[MT][NT][4];                  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
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

    const unsigned char* xs = smem + (kt % kStages) * kStageBytes;
    const unsigned char* ws = xs + kXBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[NT][2];                 // the warp's n8 tiles
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t r[4];
        repro::ldmatrix_x4_trans(
            r, ws + repro::swz_frag(fa, kk * 16, warp * NT + j * 2, kWChunks));
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < n_mt) {
          uint32_t a[4];
          repro::ldmatrix_x4(
              a, xs + repro::swz_frag(fa, mt * 16, kk * 2, kXChunks));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            repro::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

  // every row of the group is written; rows past `live` hold zeros
  bf16* og = out + (static_cast<size_t>(e) * C + r0) * F;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = f0 + (warp * NT + nt) * 8 + 2 * t;
        if (col < F)
          *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(r) * F +
                                       col) =
              repro::pack_bf16x2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <int MT>
int launch_tc(const void* x, const void* w, void* out, const int* counts,
              int E, int C, int K, int F, cudaStream_t stream) {
  constexpr int smem = tc::kStages * tc::stage_bytes<MT>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tc<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + tc::kBN - 1) / tc::kBN, (C + MT * 16 - 1) / (MT * 16),
                  E);
  gmm_tc<MT><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), counts, C, K, F);
  return (int)cudaGetLastError();
}

bool grid_fits(int E, int C, int rows_per_block) {
  return E >= 1 && C >= 1 && E <= 65535 &&
         (C + rows_per_block - 1) / rows_per_block <= 65535;
}

}  // namespace

// C entry points (ctypes).  x (E, C, K), w (E, K, F) and out (E, C, F)
// must be contiguous and share one dtype; `counts` is null or (E,) int32
// on the same device.  Each returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a shape or dtype the instance does not take.

// the CUDA-core instance: fp32 or bf16, any shape
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out,
                             const void* counts, int E, int C, int K, int F,
                             int dtype, void* stream) {
  if (K < 1 || F < 1 || !grid_fits(E, C, kBC)) return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  if (dtype == repro::kF32)
    return launch<float>(x, w, out, cn, E, C, K, F, st);
  if (dtype == repro::kBF16) return launch<bf16>(x, w, out, cn, E, C, K, F, st);
  return repro::kUnsupported;
}

// the tensor-core instance: bf16, K and F multiples of 8, 16-byte aligned
// x and w
extern "C" int repro_moe_gmm_tc(const void* x, const void* w, void* out,
                                const void* counts, int E, int C, int K,
                                int F, void* stream) {
  if (K < 8 || F < 8 || K % 8 || F % 8 || !grid_fits(E, C, 64) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  // rows per block: C rounded up to 16, at most 64
  switch (min(4, (C + 15) / 16)) {
    case 1:
      return launch_tc<1>(x, w, out, cn, E, C, K, F, st);
    case 2:
      return launch_tc<2>(x, w, out, cn, E, C, K, F, st);
    case 3:
      return launch_tc<3>(x, w, out, cn, E, C, K, F, st);
    default:
      return launch_tc<4>(x, w, out, cn, E, C, K, F, st);
  }
}
