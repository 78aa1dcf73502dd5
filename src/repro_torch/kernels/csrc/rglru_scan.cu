// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces: src/repro/kernels/rglru_scan/rglru_scan.py, `rglru_scan_kernel`
// (the Pallas TPU kernel, pl.pallas_call at :53).  Same recurrence over
// a, b (batch, seq, ch) with an fp32 carry and the output in the inputs'
// dtype.  Unlike the TPU kernel it starts from a given state h0 (batch, ch)
// fp32 (null = zeros), as the model's scan does
// (src/repro/models/rglru.py:43); the caller reads the final state as
// h[:, -1].
//
// What bounds it on the H100: the recurrence is serial in t and does one
// multiply-add per element, so the work is bytes: each input read once
// and h written once, 3 x 4 B x 300 x 2560 = 9.2 MB for recurrentgemma-2b's
// fp32 (1, 300, 2560) prefill, 2.75 us at 3.35 TB/s.  At batch 1 only
// 2,560 threads run (20 blocks on 132 SMs), so the real limit is latency:
// each thread walks 300 steps, and a step's loads cannot start before the
// previous ones' unless they are issued ahead.
//
// Design: one thread per (batch row, channel), walking t in order, so
// neighbouring threads read neighbouring channels (coalesced).  The loads
// of kUnroll steps are issued before their multiply-adds, so that many
// memory requests are in flight at once.  The multiply and the add round
// separately (__fmul_rn / __fadd_rn, no contraction), as the plain
// version's two elementwise ops do, so the kernel is bit-exact against it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_fwd(const T* __restrict__ a, const T* __restrict__ b,
               const float* __restrict__ h0, T* __restrict__ h, int seq,
               int ch) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= ch) return;
  const long long row = blockIdx.y;
  const long long base = row * seq * ch + c;
  float hc = h0 != nullptr ? h0[row * ch + c] : 0.f;
  int t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)(t + u) * ch;
      av[u] = repro::to_f32(a[i]);
      bv[u] = repro::to_f32(b[i]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hc = __fadd_rn(__fmul_rn(av[u], hc), bv[u]);
      h[base + (long long)(t + u) * ch] = repro::from_f32<T>(hc);
    }
  }
  for (; t < seq; ++t) {
    const long long i = base + (long long)t * ch;
    hc = __fadd_rn(__fmul_rn(repro::to_f32(a[i]), hc), repro::to_f32(b[i]));
    h[i] = repro::from_f32<T>(hc);
  }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h, int batch,
           int seq, int ch, cudaStream_t stream) {
  const dim3 grid((ch + kThreads - 1) / kThreads, batch);
  rglru_scan_fwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), seq, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes).  a, b, h: contiguous (batch, seq, ch) of one
// dtype; h0: contiguous (batch, ch) fp32 or null.  Returns 0 on success,
// the cudaError_t of a refused launch, or -1 for a dtype it does not take.
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, int batch, int seq, int ch,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  if (dtype == repro::kF32)
    return launch<float>(a, b, h0f, h, batch, seq, ch, st);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(a, b, h0f, h, batch, seq, ch, st);
  return repro::kUnsupported;
}
