// Grouped (per-expert) matrix product for Hopper (sm_90a): the MoE expert
// FFN's three products over the capacity-dispatched layout.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py, `moe_gmm_kernel` (the
// Pallas TPU kernel, pl.pallas_call at :50).  Same function: x (E, C, K),
// w (E, K, F) -> out (E, C, F), out[e] = x[e] @ w[e], products summed in
// fp32, output in x's dtype.  Unlike the Pallas kernel, whose tiles must
// divide C, K and F (moe_gmm.py:47), this one masks ragged tiles, so it
// takes any shape: deepseek-moe-16b's wo product has K = 1408, which the
// Pallas kernel's default block_k of 512 does not divide.
//
// What bounds it on the H100: on the serving path C is small (24-48 rows
// per expert for deepseek-moe-16b), so each bf16 weight element feeds at
// most C multiply-adds, about 24-48 flops per byte: below the ~295 flops
// per byte where the tensor cores would be the limit, so the bound is
// the weights' bytes (369 MB per product at deepseek's widths, 0.11 ms
// at 3.35 TB/s).  This kernel multiplies on the fp32 CUDA cores (67
// TFLOP/s), so it is bound by operations instead: 17.7 GFLOP per decode
// product take at least 0.26 ms there.
//
// Design: one block of 128 threads per (64-column F tile, 64-row C tile,
// expert); with C <= 64 every weight element is read from device memory
// exactly once.  A loop over K in steps of 32 takes the place of the
// TPU's sequential K grid dimension: each step stages a 64 x 32 tile of
// x (transposed, rows padded to 68 floats) and a 32 x 64 tile of w in
// shared memory as fp32, masked to zero past C, K and F, and each thread
// accumulates an 8-row x 4-column tile in fp32 registers, in the order
// of k, so the result does not depend on the launch.  Warps whose rows
// all lie past C skip the multiply-adds.  Tensor cores (mma / wgmma), TMA
// and skipping the capacity layout's unused rows are later work.
#include "common.cuh"

namespace {

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
               T* __restrict__ out, int C, int K, int F) {
  __shared__ __align__(16) float Xs[kBK][kXStride];   // Xs[k][row]
  __shared__ __align__(16) float Ws[kBK][kBF];        // Ws[k][col]

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kBC;
  const int f0 = blockIdx.x * kBF;
  const T* xe = x + static_cast<size_t>(e) * C * K;
  const T* we = w + static_cast<size_t>(e) * K * F;
  T* oe = out + static_cast<size_t>(e) * C * F;

  const int tid = threadIdx.x;
  const int tx = tid % (kBF / kTC);      // column group
  const int ty = tid / (kBF / kTC);      // row group
  const bool live = c0 + ty * kTR < C;

  float acc[kTR][kTC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: a warp reads 32 consecutive k of one row (coalesced)
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = i * kThreads + tid;
      const int r = idx / kBK, kk = idx % kBK;
      const int gr = c0 + r, gk = k0 + kk;
      Xs[kk][r] = (gr < C && gk < K)
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

  if (!live) return;
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
int launch(const void* x, const void* w, void* out, int E, int C, int K,
           int F, cudaStream_t stream) {
  const dim3 grid((F + kBF - 1) / kBF, (C + kBC - 1) / kBC, E);
  grouped_matmul<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, K, F);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes).  x (E, C, K), w (E, K, F) and out (E, C, F)
// must be contiguous and share one dtype.  Returns 0 on success, the
// cudaError_t of a refused launch, or -1 for a shape or dtype the kernel
// does not take (an empty dimension, more than 65535 experts or C
// tiles).
extern "C" int repro_moe_gmm(const void* x, const void* w, void* out, int E,
                             int C, int K, int F, int dtype, void* stream) {
  if (E < 1 || C < 1 || K < 1 || F < 1 || E > 65535 ||
      (C + kBC - 1) / kBC > 65535)
    return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return launch<float>(x, w, out, E, C, K, F, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, w, out, E, C, K, F, st);
  return repro::kUnsupported;
}
