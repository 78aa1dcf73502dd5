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
// multiply and one add per element, so the work is bytes: each input read
// once and h written once, 3 x 4 B x 300 x 2560 = 9.2 MB for
// recurrentgemma-2b's fp32 (1, 300, 2560) prefill, 2.75 us at 3.35 TB/s.
// At batch 1 the real limit is latency: a channel's 300 steps are a chain
// of 600 dependent fp32 operations, 8 cycles a step (~1.2 us at 1.98 GHz),
// and every shared-memory or device-memory instruction the warp that runs
// the chain issues costs it more than the chain's own arithmetic.
//
// Design: a block owns one batch row's G = 32 adjacent channels (32 fp32
// values are one 128-byte line a step).  Its first warp, one lane per
// channel, runs the recurrence; the other three warps copy.  The copiers
// stage a and b into shared memory kChunk = 32 steps at a time through a
// cp.async ring of kStages slots (16 bytes a copy, zero-filled past the
// sequence or the channels; plain loads where the rows are not 16-byte
// aligned), kStages - 1 chunks ahead.  A scanning lane loads its
// channel's 32 a_t and b_t into registers before the chain (a load issued
// after one of the chain's stores would wait out its latency inside the
// chain) and stores each h_t to a shared-memory buffer; the copiers write
// that chunk's h out 16 bytes a thread while the next chunk is scanned.
// One barrier a chunk hands over the landed slot, the h buffer and the
// freed slot.  The multiply and the add round separately (__fmul_rn /
// __fadd_rn, no contraction), as the plain version's two elementwise ops
// do, so the kernel is bit-exact against it.
//
// What was measured (PERF.md): 16-channel groups (160 blocks at
// batch 1 on 132 SMs, against 80) and two batch rows a block were both
// slower than this tile, at batch 1 and at batch 4, and were dropped.
// Layouts that vectorise the chain along t (each channel's steps
// contiguous, so one 16-byte load serves four steps) needed a transpose
// in the copiers whose shared-memory traffic slowed the chain more than
// the vector loads sped it up.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;   // warp 0 scans, warps 1-3 copy
constexpr int kG = 32;          // channels a block, one lane each
constexpr int kChunk = 32;      // timesteps a chunk
constexpr int kStages = 4;      // cp.async ring slots; kStages - 1 ahead
constexpr int kCopyThreads = kThreads - kG;
constexpr int kElems = kChunk * kG;             // a chunk, [t][c]

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_fwd(const T* __restrict__ a, const T* __restrict__ b,
               const float* __restrict__ h0, T* __restrict__ h, int seq,
               int ch, bool vec) {
  constexpr int VE = 16 / (int)sizeof(T);       // elements a vector
  constexpr int VPR = kG / VE;                  // vectors a chunk row
  constexpr int kUnits = kChunk * VPR;          // vectors a chunk
  // a and b in each ring slot, h twice over
  __shared__ __align__(16) T xs[kStages][2][kElems];
  __shared__ __align__(16) T hs[2][kElems];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kG;
  const long long base = (long long)blockIdx.y * seq * ch + c0;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const bool copier = tid >= kG;
  const int ct = tid - kG;                      // index among the copiers

  // offset of element (t, c) of chunk k, and whether it exists
  auto at = [&](int k, int t, int c, bool* ok) {
    *ok = k * kChunk + t < seq && c0 + c < ch;
    return base + (long long)(k * kChunk + t) * ch + c;
  };
  // chunk k of a and b into its ring slot, zero-filled: 16 bytes a
  // cp.async where the rows are 16-byte aligned, else plain loads
  auto issue = [&](int k) {
    T* xa = xs[k % kStages][0];
    T* xb = xs[k % kStages][1];
    if (vec) {
      for (int u = ct; u < kUnits; u += kCopyThreads) {
        bool ok;
        long long g = at(k, u / VPR, (u % VPR) * VE, &ok);
        if (!ok) g = 0;
        repro::cp_async_16(xa + u * VE, a + g, ok ? 16 : 0);
        repro::cp_async_16(xb + u * VE, b + g, ok ? 16 : 0);
      }
    } else {
      const T zero = repro::from_f32<T>(0.f);
      for (int e = ct; e < kElems; e += kCopyThreads) {
        bool ok;
        const long long g = at(k, e / kG, e % kG, &ok);
        xa[e] = ok ? a[g] : zero;
        xb[e] = ok ? b[g] : zero;
      }
    }
  };
  // chunk k's h from its buffer to h, 16 bytes a store where rows allow
  auto drain = [&](int k) {
    const T* hb = hs[k & 1];
    if (vec) {
      for (int u = ct; u < kUnits; u += kCopyThreads) {
        bool ok;
        const long long g = at(k, u / VPR, (u % VPR) * VE, &ok);
        if (ok)
          *reinterpret_cast<uint4*>(h + g) =
              *reinterpret_cast<const uint4*>(hb + u * VE);
      }
    } else {
      for (int e = ct; e < kElems; e += kCopyThreads) {
        bool ok;
        const long long g = at(k, e / kG, e % kG, &ok);
        if (ok) h[g] = hb[e];
      }
    }
  };

  const int c = tid;
  const bool live = !copier && c0 + c < ch;
  float hc = 0.f;
  if (live && h0 != nullptr) hc = h0[(long long)blockIdx.y * ch + c0 + c];

  if (copier) {
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_chunks) issue(k);
      repro::cp_async_commit();
    }
  }
  for (int k = 0; k < n_chunks; ++k) {
    // chunk k has landed for every copier; the barrier makes it visible,
    // hands over chunk k - 1's h and frees the slot of chunk k - 1
    if (copier) repro::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (copier) {
      if (k + kStages - 1 < n_chunks) issue(k + kStages - 1);
      repro::cp_async_commit();
      if (k > 0) drain(k - 1);
      continue;
    }
    if (!live) continue;
    // the chunk's a and b into registers before the chain: a load placed
    // after an h store would wait out its latency inside the chain
    const T* xa = xs[k % kStages][0] + c;
    const T* xb = xs[k % kStages][1] + c;
    T* ho = hs[k & 1] + c;
    T av[kChunk], bv[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      av[t] = xa[t * kG];
      bv[t] = xb[t * kG];
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      hc = __fadd_rn(__fmul_rn(repro::to_f32(av[t]), hc),
                     repro::to_f32(bv[t]));
      ho[t * kG] = repro::from_f32<T>(hc);
    }
  }
  __syncthreads();
  if (copier) drain(n_chunks - 1);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* h, int batch,
           int seq, int ch, cudaStream_t stream) {
  const bool vec = aligned16(a) && aligned16(b) && aligned16(h) &&
                   ((long long)ch * sizeof(T)) % 16 == 0;
  const dim3 grid((ch + kG - 1) / kG, batch);
  rglru_scan_fwd<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), seq, ch, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes).  a, b, h: contiguous (batch, seq, ch) of one
// dtype, any alignment; h0: contiguous (batch, ch) fp32 or null.  Returns
// 0 on success, the cudaError_t of a refused launch, or -1 for a dtype it
// does not take.
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
