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
//
// The reverse scan (`rglru_scan_bwd`, the gradient).  Replaces: no Pallas
// kernel.  The reference differentiates its associative scan with XLA
// (src/repro/models/rglru.py:43-77, `one_chunk` at :55); the gradient of
// h_t = a_t h_{t-1} + b_t is itself a linear recurrence, run from the
// end:
//   g_{S-1} = dh_{S-1},  g_t = dh_t + a_{t+1} g_{t+1}
//   db_t = g_t,  da_t = g_t h_{t-1} (h_{-1} = h0, or zeros),
//   dh0 = a_0 g_0.
// What bounds it: bytes again.  It reads a, h and dh and writes da and db,
// 5 x 4 B x 4096 x 2560 = 210 MB for recurrentgemma-2b's fp32 training
// sequence of 4,096 tokens, 62.6 us at 3.35 TB/s, against a chain of
// 4,096 dependent multiply-adds per channel (~20 us at 1.98 GHz); at batch
// 1 only 80 blocks of the 132 SMs' worth are live, so the copies in flight
// per block set the pace.  Design: the forward's tile and roles run over
// the chunks in reverse.  A ring slot holds a chunk's a, its h shifted one
// step back (row t holds h_{t-1}: the copiers stage the row before the
// chunk, so the chunk's first da needs nothing from the next chunk to be
// scanned) and dh; rows before 0 and past the end are zero-filled, so the
// scan starts from the end of the last chunk with g = 0 and a_{t+1} = 0,
// and row -1 is replaced by h0 in the scanning lane.  a_{t+1} of a chunk's
// last step is the first a of the chunk scanned before it, carried in a
// register.  The scanning lane loads its 3 x 32 values into registers
// first, then runs the chain and writes db over dh and da over h_{t-1} in
// the same slot, which the copiers write out one chunk later; so the ring
// has kBwdStages = 5 slots with 3 chunks in flight ahead of the scan (60
// KB of dynamic shared memory in fp32).  The same two rounded ops as the
// plain version, so it is bit-exact against it.
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

constexpr int kBwdStages = 5;              // reverse scan's ring slots
constexpr int kBwdAhead = kBwdStages - 2;    // chunks copied ahead of it

template <typename T>
constexpr int bwd_smem() {   // [slot][a, h_{t-1} (then da), dh (then db)]
  return kBwdStages * 3 * kElems * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd(const T* __restrict__ a, const T* __restrict__ h,
               const T* __restrict__ dh, const float* __restrict__ h0,
               T* __restrict__ da, T* __restrict__ db,
               float* __restrict__ dh0, int seq, int ch, bool vec) {
  constexpr int VE = 16 / (int)sizeof(T);
  constexpr int VPR = kG / VE;
  constexpr int kUnits = kChunk * VPR;
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  T* const ring = reinterpret_cast<T*>(smem_bwd);
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kG;
  const long long base = (long long)blockIdx.y * seq * ch + c0;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const bool copier = tid >= kG;
  const int ct = tid - kG;

  // array j (0: a, 1: h_{t-1} / da, 2: dh / db) of the p-th chunk scanned,
  // which is chunk n_chunks - 1 - p
  auto slot = [&](int p, int j) {
    return ring + ((p % kBwdStages) * 3 + j) * kElems;
  };
  // offset of element (row k * kChunk + t + shift, c), and whether it exists
  auto at = [&](int k, int t, int shift, int c, bool* ok) {
    const int row = k * kChunk + t + shift;
    *ok = row >= 0 && row < seq && c0 + c < ch;
    return base + (long long)row * ch + c;
  };
  auto issue = [&](int p) {
    const int k = n_chunks - 1 - p;
    T* xa = slot(p, 0);
    T* xh = slot(p, 1);
    T* xd = slot(p, 2);
    if (vec) {
      for (int u = ct; u < kUnits; u += kCopyThreads) {
        const int t = u / VPR, c = (u % VPR) * VE;
        bool ok;
        long long g = at(k, t, 0, c, &ok);
        if (!ok) g = 0;
        repro::cp_async_16(xa + u * VE, a + g, ok ? 16 : 0);
        repro::cp_async_16(xd + u * VE, dh + g, ok ? 16 : 0);
        g = at(k, t, -1, c, &ok);
        if (!ok) g = 0;
        repro::cp_async_16(xh + u * VE, h + g, ok ? 16 : 0);
      }
    } else {
      const T zero = repro::from_f32<T>(0.f);
      for (int e = ct; e < kElems; e += kCopyThreads) {
        const int t = e / kG, c = e % kG;
        bool ok;
        long long g = at(k, t, 0, c, &ok);
        xa[e] = ok ? a[g] : zero;
        xd[e] = ok ? dh[g] : zero;
        g = at(k, t, -1, c, &ok);
        xh[e] = ok ? h[g] : zero;
      }
    }
  };
  // the p-th chunk's da and db from its slot to da and db
  auto drain = [&](int p) {
    const int k = n_chunks - 1 - p;
    const T* oa = slot(p, 1);
    const T* ob = slot(p, 2);
    if (vec) {
      for (int u = ct; u < kUnits; u += kCopyThreads) {
        bool ok;
        const long long g = at(k, u / VPR, 0, (u % VPR) * VE, &ok);
        if (ok) {
          *reinterpret_cast<uint4*>(da + g) =
              *reinterpret_cast<const uint4*>(oa + u * VE);
          *reinterpret_cast<uint4*>(db + g) =
              *reinterpret_cast<const uint4*>(ob + u * VE);
        }
      }
    } else {
      for (int e = ct; e < kElems; e += kCopyThreads) {
        bool ok;
        const long long g = at(k, e / kG, 0, e % kG, &ok);
        if (ok) {
          da[g] = oa[e];
          db[g] = ob[e];
        }
      }
    }
  };

  const int c = tid;
  const bool live = !copier && c0 + c < ch;
  float g = 0.f, a_next = 0.f, hinit = 0.f;
  if (live && h0 != nullptr) hinit = h0[(long long)blockIdx.y * ch + c0 + c];

  if (copier) {
    for (int p = 0; p < kBwdAhead; ++p) {
      if (p < n_chunks) issue(p);
      repro::cp_async_commit();
    }
  }
  for (int p = 0; p < n_chunks; ++p) {
    // chunk p has landed for every copier; the barrier makes it visible,
    // hands chunk p - 1's da and db to the copiers and frees the slot of
    // chunk p - 2 (written out in the last round) for chunk p + kBwdAhead
    if (copier) repro::cp_async_wait<kBwdAhead - 1>();
    __syncthreads();
    if (copier) {
      if (p > 0) drain(p - 1);
      if (p + kBwdAhead < n_chunks) issue(p + kBwdAhead);
      repro::cp_async_commit();
      continue;
    }
    if (!live) continue;
    T* xa = slot(p, 0) + c;
    T* xh = slot(p, 1) + c;
    T* xd = slot(p, 2) + c;
    // every input of the chunk into registers first: the chain writes
    // its outputs over them
    T av[kChunk], hv[kChunk], dv[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      av[t] = xa[t * kG];
      hv[t] = xh[t * kG];
      dv[t] = xd[t * kG];
    }
    const float h_first = p == n_chunks - 1 ? hinit : repro::to_f32(hv[0]);
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      g = __fadd_rn(repro::to_f32(dv[t]), __fmul_rn(a_next, g));
      const float hp = t == 0 ? h_first : repro::to_f32(hv[t]);
      xd[t * kG] = repro::from_f32<T>(g);
      xh[t * kG] = repro::from_f32<T>(__fmul_rn(g, hp));
      a_next = repro::to_f32(av[t]);
    }
  }
  __syncthreads();
  if (copier && n_chunks > 0) drain(n_chunks - 1);
  if (live && dh0 != nullptr)
    dh0[(long long)blockIdx.y * ch + c0 + c] = __fmul_rn(a_next, g);
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

template <typename T>
int launch_bwd(const void* a, const void* h, const void* dh, const float* h0,
               void* da, void* db, float* dh0, int batch, int seq, int ch,
               cudaStream_t stream) {
  const bool vec = aligned16(a) && aligned16(h) && aligned16(dh) &&
                   aligned16(da) && aligned16(db) &&
                   ((long long)ch * sizeof(T)) % 16 == 0;
  constexpr int smem = bwd_smem<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ch + kG - 1) / kG, batch);
  rglru_scan_bwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), h0, static_cast<T*>(da),
      static_cast<T*>(db), dh0, seq, ch, vec);
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

// C entry point of the reverse scan (ctypes).  a, h (the forward's
// output), dh, da, db: contiguous (batch, seq, ch) of one dtype, any
// alignment; h0: contiguous (batch, ch) fp32 or null (zeros); dh0: (batch,
// ch) fp32, written when not null.  Returns as the forward's.
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* dh, const void* h0, void* da,
                                    void* db, void* dh0, int batch, int seq,
                                    int ch, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* dh0f = static_cast<float*>(dh0);
  if (dtype == repro::kF32)
    return launch_bwd<float>(a, h, dh, h0f, da, db, dh0f, batch, seq, ch,
                             st);
  if (dtype == repro::kBF16)
    return launch_bwd<__nv_bfloat16>(a, h, dh, h0f, da, db, dh0f, batch, seq,
                                     ch, st);
  return repro::kUnsupported;
}
