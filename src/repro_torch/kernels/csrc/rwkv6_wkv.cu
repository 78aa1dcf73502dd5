// RWKV-6 WKV recurrence for Hopper (sm_90a), serial form.
//
// Replaces: src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py, `rwkv6_wkv_kernel`
// (the Pallas TPU kernel, pl.pallas_call at :78).  Per (batch row, head),
// with an n x n fp32 state S:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
// Unlike the TPU kernel it starts from a given state s0 (b, h, n, n)
// (null = zeros), returns the final state (and, for the reverse below,
// the state before every 32-token chunk when asked), and takes any
// sequence length (the TPU kernel needs s % 64 == 0), as the model's
// time mix needs (src/repro/models/rwkv.py:149-153).  It keeps the serial recurrence and
// not the TPU's chunked form: that form subtracts cumulative log-decay
// sums which, at the decays the model allows (logw = -exp(d), d up to
// 10), reach ~1e6 and lose ~1e-2 in fp32; the serial form is exact
// against the per-token plain version up to the order of its sums.
//
// What bounds it on the H100: rwkv6-3b's fp32 prefill of 300 tokens reads
// r, k, v, logw (1, 300, 40, 64) and writes o and the 40 x 64 x 64 state,
// 16 MB, 4.8 us at 3.35 TB/s; its ~5 n^2 flops per token and head are
// 0.25 GFLOP, 3.7 us at the 67 TFLOP/s fp32 peak.  At batch 1 the real
// limit is the serial chain of 300 steps: each step's n^2 work spread
// over the threads of a head, and what the step reads from shared memory.
//
// Design: columns of S are independent (o_t[j] and S[:, j] read column j
// and the shared r_t, k_t, w_t, u), so the grid is (n / 32, h, b) (one
// block of 16 columns at n 16): 80 blocks of 256 threads at rwkv6-3b's
// batch 1, each of 32 columns.  A
// block has 16 column groups of 16 adjacent lanes; lane q of a group
// holds S[q n/16 .. q n/16 + n/16, 2 columns] (8 registers at n 64) and
// its slice of u, so each r, k, w it reads from shared memory serves two
// columns.  (One column a thread was bound by those shared-memory reads;
// four a thread by the issue rate of warps left alone on their
// schedulers.)  Each step's per-lane partials sum_i r_i S_ij + v_j sum_i
// r_i u_i k_i are summed over the 16 lanes 8 steps x 2 columns at a time
// by recursive halving: 15 shuffles, after which lane q holds one output,
// where a butterfly per output would take 4 each.  The inputs do not
// depend on the state, so they are staged a chunk of T = 32 tokens at a
// time: r, k, logw (T x n each) and the block's v columns (T x 32) go
// into shared memory by cp.async in a 3-stage ring, two chunks ahead of
// the one being computed.  Each thread turns the logw it copied into w =
// exp(logw) once its copies land, so a chunk needs one barrier, not one
// per token; the refill of the next stage and the write-out of the last
// chunk's outputs (buffered in shared memory, written 16 bytes a thread)
// are spread over the chunk's first groups of steps, where they fill
// issue slots the arithmetic leaves idle.  Rows past the sequence's end
// are zero-filled (r = k = v = 0, w = 1): they leave S unchanged, so
// every chunk runs the same fully unrolled 32 steps.  Rows that are
// 16-byte aligned (all four inputs' pointers and strides) are copied 16
// bytes at a time, others element by element (cp.async of 4 bytes for
// fp32, plain loads for bf16).  All arithmetic is fp32 on the CUDA cores
// (no TF32).
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kT = 32;                   // tokens per staged chunk
constexpr int kStages = 3;               // chunks in the ring
constexpr int kR = 16;                   // lanes of a column group
constexpr int kJC = 2;                   // state columns per thread
constexpr int kG = 8;                    // steps summed over lanes at once
constexpr int kJB = 32;                  // state columns per block (n >= 32)
static_assert(kG * kJC == kR, "one output per lane per group");
static_assert(kT % kG == 0 && kT / kG >= 4, "four or more groups a chunk");

struct Strides {
  long long b, s, h;                     // in elements; n is contiguous
};

// 4-byte async copy; bytes past `src_bytes` (0 or 4) are written as zeros
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   repro::smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

template <typename T, int N>
struct Cfg {
  static constexpr int JB = N < kJB ? N : kJB;    // columns per block
  static constexpr int kThreads = JB / kJC * kR;
  static constexpr int RPT = N / kR;     // state rows per thread
  static constexpr int E = 16 / sizeof(T);        // elements per 16 bytes
  // fp32 logw is turned into w in place; bf16 needs an fp32 buffer
  static constexpr bool kSepW = !std::is_same<T, float>::value;
  // one stage, in elements of T: r, k, logw (kT x N each), v (kT x JB)
  static constexpr int kStageElems = 3 * kT * N + kT * JB;
  static constexpr size_t kStageBytes = kStageElems * sizeof(T);
  static constexpr size_t kWBytes = kSepW ? kT * N * sizeof(float) : 0;
  static constexpr size_t kSmem = kStages * (kStageBytes + kWBytes);
  static_assert(N % kR == 0 && N % JB == 0, "head size");
  static_assert(kStageBytes % 16 == 0 && kWBytes % 16 == 0, "alignment");
};

// Copy kT rows of `cols` elements (row stride `stride` in device memory,
// packed in shared memory); rows at or past `nt` are written as zeros.
// With `vec`, thread tid copies the 16-byte pieces tid, tid + kThreads,
// ... of the packed tile, the ones `exp_own` below converts.
template <typename T, int N, int cols>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int nt,
                                           bool vec, int tid) {
  using C = Cfg<T, N>;
  if (vec) {
    constexpr int cpr = cols / C::E, kPieces = kT * cpr;
#pragma unroll
    for (int p = 0; p < (kPieces + C::kThreads - 1) / C::kThreads; ++p) {
      const int idx = tid + p * C::kThreads;
      if (kPieces % C::kThreads != 0 && idx >= kPieces) break;
      const int t = idx / cpr, ch = idx - t * cpr;
      const bool live = t < nt;
      repro::cp_async_16(dst + idx * C::E,
                         src + (live ? t : 0) * stride + ch * C::E,
                         live ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kT * cols; idx += C::kThreads) {
      const int t = idx / cols, e = idx - t * cols;
      const bool live = t < nt;
      const T* from = src + (live ? t : 0) * stride + e;
      if constexpr (sizeof(T) == 4)
        cp_async_4(dst + idx, from, live ? 4 : 0);
      else
        dst[idx] = live ? *from : repro::from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ void unpack16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// w = exp(logw) for the logw of the kT x N tile that this thread staged
// (it has waited for its own copies, so no barrier is needed before this):
// all its pieces are loaded first, then converted and stored.
template <typename T, int N>
__device__ __forceinline__ void exp_own(float* w, const T* lw, bool vec,
                                        int tid) {
  using C = Cfg<T, N>;
  if (vec) {
    constexpr int kPieces = kT * N / C::E;
    constexpr int P = (kPieces + C::kThreads - 1) / C::kThreads;
    float x[P][C::E];
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (tid + p * C::kThreads < kPieces)
        unpack16(lw + (tid + p * C::kThreads) * C::E, x[p]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (tid + p * C::kThreads >= kPieces) break;
      float* dst = w + (tid + p * C::kThreads) * C::E;
#pragma unroll
      for (int e = 0; e < C::E; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(expf(x[p][e]), expf(x[p][e + 1]), expf(x[p][e + 2]),
                        expf(x[p][e + 3]));
    }
  } else {
    for (int idx = tid; idx < kT * N; idx += C::kThreads)
      w[idx] = expf(repro::to_f32(lw[idx]));
  }
}

// M consecutive floats of shared memory (16-byte aligned when M % 4 == 0)
template <int M>
__device__ __forceinline__ void load_row(const float* p, float (&x)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int a = 0; a < M / 4; ++a) {
      const float4 f = reinterpret_cast<const float4*>(p)[a];
      x[4 * a] = f.x;
      x[4 * a + 1] = f.y;
      x[4 * a + 2] = f.z;
      x[4 * a + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = p[i];
  }
}

template <int M>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = __bfloat162float(p[i]);
}

// p[m] (m < kR) summed over the kR lanes of a column group, lane q
// returning the sum of p[q]: recursive halving, each level keeping the
// half of the values its lane bit selects and adding the partner's copy
// of that half (kR - 1 shuffles for kR sums).  One template level per
// halving, so every index is a constant and p stays in registers.
template <int HALF>
__device__ __forceinline__ float sum_transposed(float (&p)[kR], int q) {
  const bool hi = q & HALF;
#pragma unroll
  for (int i = 0; i < HALF; ++i)
    p[i] = (hi ? p[i + HALF] : p[i]) +
           __shfl_xor_sync(0xffffffffu, hi ? p[i] : p[i + HALF], HALF);
  if constexpr (HALF > 1)
    return sum_transposed<HALF / 2>(p, q);
  else
    return p[0];
}

template <typename T, int N>
__global__ void __launch_bounds__(Cfg<T, N>::kThreads)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ logw,
        const float* __restrict__ u, const float* __restrict__ s0,
        T* __restrict__ o, float* __restrict__ s_out,
        float* __restrict__ states, int heads, int seq, Strides rs,
        Strides ks, Strides vs, Strides ws, Strides os, bool vec) {
  using C = Cfg<T, N>;
  constexpr int RPT = C::RPT, JB = C::JB, NT = C::kThreads, E = C::E;
  extern __shared__ __align__(16) unsigned char smem[];
  // outputs of two chunks; an array of its own, so the compiler knows
  // its stores do not alias the ring's loads
  __shared__ __align__(16) T obuf[2][kT * JB];
  T* stages = reinterpret_cast<T*>(smem);
  float* wsep = reinterpret_cast<float*>(smem + kStages * C::kStageBytes);

  const int jb = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, q = tid % kR, cg = tid / kR;
  const int j0 = jb * JB + cg * kJC;      // this thread's first column
  const T* rb = r + ib * rs.b + ih * rs.h;
  const T* kb = k + ib * ks.b + ih * ks.h;
  const T* wb = logw + ib * ws.b + ih * ws.h;
  const T* vb = v + ib * vs.b + ih * vs.h + jb * JB;
  T* ob = o + ib * os.b + ih * os.h + jb * JB;
  const long long sbase = ((long long)ib * heads + ih) * N * N;

  float S[RPT][kJC], uu[RPT];
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii) {
    const int i = q * RPT + ii;
    uu[ii] = u[ih * N + i];
#pragma unroll
    for (int c = 0; c < kJC; ++c)
      S[ii][c] = s0 != nullptr ? s0[sbase + i * N + j0 + c] : 0.f;
  }

  auto stage_r = [&](int st) { return stages + st * C::kStageElems; };
  auto stage_w = [&](int st) {
    if constexpr (C::kSepW) return wsep + st * kT * N;
    else return reinterpret_cast<float*>(stage_r(st) + 2 * kT * N);
  };
  // one of chunk c's four input tiles (r, k, logw, v) into its stage
  auto stage = [&](int c, int tile) {
    const int t0 = c * kT, nt = min(kT, seq - t0);
    T* dst = stage_r(c % kStages) + tile * kT * N;
    if (tile < 3) {
      const T* src = tile == 0 ? rb : tile == 1 ? kb : wb;
      const long long stride = tile == 0 ? rs.s : tile == 1 ? ks.s : ws.s;
      stage_rows<T, N, N>(dst, src + t0 * stride, stride, nt, vec, tid);
    } else {
      stage_rows<T, N, JB>(dst, vb + t0 * vs.s, vs.s, nt, vec, tid);
    }
  };
  auto write_out = [&](int c) {
    const int t0 = c * kT, nt = min(kT, seq - t0);
    const T* src = obuf[c & 1];
    constexpr int ppr = JB / E;          // 16 bytes a thread
    for (int idx = tid; idx < nt * ppr; idx += NT) {
      const int t = idx / ppr, ch = idx - t * ppr;
      *reinterpret_cast<uint4*>(ob + (t0 + t) * os.s + ch * E) =
          *reinterpret_cast<const uint4*>(src + idx * E);
    }
  };

  const int n_chunks = (seq + kT - 1) / kT;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) {
#pragma unroll
      for (int tile = 0; tile < 4; ++tile) stage(c, tile);
    }
    repro::cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    if (states != nullptr) {             // the state before chunk c
      float* sc = states + (sbase / (N * N) * n_chunks + c) * N * N + j0;
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii)
        *reinterpret_cast<float2*>(sc + (q * RPT + ii) * N) =
            make_float2(S[ii][0], S[ii][1]);
    }
    repro::cp_async_wait<kStages - 2>();  // this thread's part of chunk c
    exp_own<T, N>(stage_w(st), stage_r(st) + 2 * kT * N, vec, tid);
    __syncthreads();   // chunk c staged; every thread is done with c - 1
    // Side work, spread over the chunk's first four groups of steps so it
    // fills their idle issue slots: chunk c - 1's outputs go out, and the
    // stage of chunk c - 1 is refilled two chunks ahead, a tile a group.
    const bool refill = c + kStages - 1 < n_chunks;
    const T* sr = stage_r(st) + q * RPT;
    const T* sk = sr + kT * N;
    const float* sw = stage_w(st) + q * RPT;
    const T* sv = stage_r(st) + 3 * kT * N + cg * kJC;
    // lane q stores step q / kJC's output of column q % kJC
    T* so = obuf[c & 1] + (q / kJC) * JB + cg * kJC + q % kJC;
#pragma unroll
    for (int t = 0; t < kT; t += kG) {
      if (t == 0 && c > 0) write_out(c - 1);
      if (refill && t < 4 * kG) stage(c + kStages - 1, t / kG);
      float p[kR];                       // p[step * kJC + column]
#pragma unroll
      for (int dt = 0; dt < kG; ++dt) {
        float rr[RPT], kk[RPT], ww[RPT], vv[kJC];
        load_row(sr + (t + dt) * N, rr);
        load_row(sk + (t + dt) * N, kk);
        load_row(sw + (t + dt) * N, ww);
        load_row(sv + (t + dt) * JB, vv);
        float bonus = 0.f;
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii)
          bonus = fmaf(rr[ii] * uu[ii], kk[ii], bonus);
#pragma unroll
        for (int c2 = 0; c2 < kJC; ++c2) {
          float a = 0.f;
#pragma unroll
          for (int ii = 0; ii < RPT; ++ii) a = fmaf(rr[ii], S[ii][c2], a);
          p[dt * kJC + c2] = fmaf(bonus, vv[c2], a);
#pragma unroll
          for (int ii = 0; ii < RPT; ++ii)
            S[ii][c2] = fmaf(ww[ii], S[ii][c2], kk[ii] * vv[c2]);
        }
      }
      so[t * JB] = repro::from_f32<T>(sum_transposed<kR / 2>(p, q));
    }
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  if (n_chunks > 0) write_out(n_chunks - 1);
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii)
#pragma unroll
    for (int c = 0; c < kJC; ++c)
      s_out[sbase + (q * RPT + ii) * N + j0 + c] = S[ii][c];
}

bool aligned16(const void* p, size_t elem, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (s.b * elem) % 16 == 0 && (s.s * elem) % 16 == 0 &&
         (s.h * elem) % 16 == 0;
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, const float* s0, void* o, float* s_out,
           float* states, int b, int h, int seq, Strides rs, Strides ks,
           Strides vs, Strides ws, Strides os, cudaStream_t stream) {
  using C = Cfg<T, N>;
  const bool vec = aligned16(r, sizeof(T), rs) &&
                   aligned16(k, sizeof(T), ks) &&
                   aligned16(v, sizeof(T), vs) &&
                   aligned16(logw, sizeof(T), ws);
  if (!aligned16(o, sizeof(T), os)) return repro::kUnsupported;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / C::JB, h, b);
  wkv_fwd<T, N><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(logw), u, s0,
      static_cast<T*>(o), s_out, states, h, seq, rs, ks, vs, ws, os, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int n, const void* r, const void* k, const void* v,
               const void* logw, const float* u, const float* s0, void* o,
               float* s_out, float* states, int b, int h, int seq,
               Strides rs, Strides ks, Strides vs, Strides ws, Strides os,
               cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, s0, o, s_out, states, b, h,
                           seq, rs, ks, vs, ws, os, stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, o, s_out, states, b, h,
                           seq, rs, ks, vs, ws, os, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, o, s_out, states, b, h,
                           seq, rs, ks, vs, ws, os, stream);
    default:
      return repro::kUnsupported;
  }
}


// ---------------------------------------------------------------------------
// The reverse: the WKV's gradient (fp32 only, what the model's time mix
// feeds it).  Replaces no Pallas kernel: the reference differentiates its
// XLA ``wkv_chunked`` (src/repro/models/rwkv.py:75, or ``wkv_scan`` at
// :36 below a chunk) and the Pallas WKV is forward only.  With G =
// dL/dS_t from dS_T (the final state's gradient, zeros if null), for
// t = s-1 .. 0:
//     dr_t[i]    = sum_j do_t[j] (S_{t-1}[i][j] + u[i] k_t[i] v_t[j])
//     dk_t[i]    = sum_j G[i][j] v_t[j] + u[i] r_t[i] (do_t . v_t)
//     dv_t[j]    = sum_i G[i][j] k_t[i] + do_t[j] sum_i r_t[i] u[i] k_t[i]
//     dlogw_t[i] = w_t[i] sum_j G[i][j] S_{t-1}[i][j]
//     du[i]     += r_t[i] k_t[i] (do_t . v_t)        (over rows and time)
//     G[i][j]   <- w_t[i] G[i][j] + r_t[i] do_t[j]
// and ds0 = G.  The state cannot be run backwards (w reaches 0 in fp32
// at the model's decays), so the forward writes the state at the start
// of every kT-token chunk (``states``) and the reverse recomputes each
// chunk's states from it, with the forward's own fmaf, so they are the
// forward's bits: the kT / kSub sub-chunk starts first, then, sub-chunk
// by sub-chunk from the last, its kSub states into registers, walked
// back in time.
//
// Layout: the forward's.  G and S are elementwise in (i, j) apart from
// the outer products, so the grid is (n / JB, h, b) and lane q of a
// column group holds rows q RPT .. q RPT + RPT of two columns of both.
// dv sums over rows, inside a column group (the forward's transposed
// halving, kSub steps x 2 columns at a time); dr, dk and dlogw sum over
// columns: the two column groups of a warp by one shuffle, the warps of
// a block through shared memory once a sub-chunk, and the n / JB column
// blocks by a second kernel (``wkv_bwd_finish``) that adds the partials
// of blocks 1.. (an fp32 workspace) to block 0's, in that order.  No
// atomics: two calls give the same bits.  do_t . v_t spans all n
// columns, so each block stages v and do whole and computes it per
// token (block 0 adds the terms it carries; du's per-row partials are
// block 0's too, summed over batch rows by the second kernel).  Inputs
// go through a 2-stage cp.async ring, the chunk before the current one
// loading while it runs.
//
// What bounds it on the H100: at rwkv6-3b's training shape (1, 4096,
// 40, 64) it reads r, k, v, logw, do and the chunk states and writes dr,
// dk, dv, dlogw (0.46 GB, 0.14 ms at 3.35 TB/s) and does ~14 n^2 flops a
// token and head (9.4 GFLOP, 0.14 ms at 67 TFLOP/s fp32); as in the
// forward, the real limit at batch 1 is the serial chain of 4,096 steps
// over 80 blocks, each step now ~3x the forward's arithmetic plus the
// states recomputed (twice for 3/4 of them) and a shuffle a row.
// ---------------------------------------------------------------------------

constexpr int kSub = 8;                  // states held in registers
constexpr int kBwdStages = 2;
static_assert(kT % kSub == 0 && kSub * kJC == kR, "sub-chunks");

template <int N>
struct BwdCfg {
  using F = Cfg<float, N>;               // the forward's tile and roles
  static constexpr int JB = F::JB, RPT = F::RPT, kThreads = F::kThreads;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSplit = N / JB;
  // one stage: r, k, logw (turned into w in place), v, do, kT x N each
  static constexpr int kStageElems = 5 * kT * N;
  // a sub-chunk's row partials (dr, dk, dlogw) of each warp
  static constexpr int kRedElems = kSub * 3 * kWarps * N;
  static constexpr size_t kSmem =
      (kBwdStages * kStageElems + kRedElems + kT) * sizeof(float);
};

template <int M>
__device__ __forceinline__ void store_row(float* p, const float (&x)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int a = 0; a < M / 4; ++a)
      reinterpret_cast<float4*>(p)[a] =
          make_float4(x[4 * a], x[4 * a + 1], x[4 * a + 2], x[4 * a + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) p[i] = x[i];
  }
}

template <int N>
__global__ void __launch_bounds__(BwdCfg<N>::kThreads)
wkv_bwd(const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ logw,
        const float* __restrict__ u, const float* __restrict__ dout,
        const float* __restrict__ ds, const float* __restrict__ states,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dlogw,
        float* __restrict__ ds0, float* __restrict__ ws, int heads, int seq,
        Strides rs, Strides ks, Strides vs, Strides wst, Strides dos,
        bool vec) {
  using C = BwdCfg<N>;
  constexpr int RPT = C::RPT, JB = C::JB, NT = C::kThreads, W = C::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* red = stages + kBwdStages * C::kStageElems;
  float* dov_s = red + C::kRedElems;

  const int jb = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int batch = gridDim.z;
  const int tid = threadIdx.x, q = tid % kR, cg = tid / kR;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = jb * JB + cg * kJC;      // this thread's first column
  const float* src[5] = {r + ib * rs.b + ih * rs.h, k + ib * ks.b + ih * ks.h,
                         logw + ib * wst.b + ih * wst.h,
                         v + ib * vs.b + ih * vs.h,
                         dout + ib * dos.b + ih * dos.h};
  const long long sstr[5] = {rs.s, ks.s, wst.s, vs.s, dos.s};
  const long long head = (long long)ib * heads + ih;
  const long long sbase = head * N * N;
  const int n_chunks = (seq + kT - 1) / kT;
  const float* st_head = states + head * n_chunks * N * N;
  // outputs (b, s, h, n) contiguous; block 0's row partials go to dr, dk,
  // dlogw, block jb's (jb >= 1) to split jb - 1 of the workspace
  const long long total = (long long)batch * seq * heads * N;
  float* out_r = jb == 0 ? dr : ws + (jb - 1) * 3 * total;
  float* out_k = jb == 0 ? dk : out_r + total;
  float* out_w = jb == 0 ? dlogw : out_r + 2 * total;
  float* du_part = ws + (C::kSplit - 1) * 3 * total + head * N;

  float G[RPT][kJC], uu[RPT], du[RPT];
#pragma unroll
  for (int ii = 0; ii < RPT; ++ii) {
    const int i = q * RPT + ii;
    uu[ii] = u[ih * N + i];
    du[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < kJC; ++c)
      G[ii][c] = ds != nullptr ? ds[sbase + i * N + j0 + c] : 0.f;
  }

  auto stage = [&](int c) {
    const int t0 = c * kT, nt = min(kT, seq - t0);
    float* dst = stages + (c % kBwdStages) * C::kStageElems;
#pragma unroll
    for (int tile = 0; tile < 5; ++tile)
      stage_rows<float, N, N>(dst + tile * kT * N, src[tile] + t0 * sstr[tile],
                              sstr[tile], nt, vec, tid);
  };

  if (n_chunks > 0) stage(n_chunks - 1);
  repro::cp_async_commit();
  for (int c = n_chunks - 1; c >= 0; --c) {
    // every thread is past chunk c + 1, whose stage now takes chunk c - 1
    if (c > 0) stage(c - 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();           // this thread's part of chunk c
    float* sr = stages + (c % kBwdStages) * C::kStageElems;
    const float* sk = sr + kT * N;
    float* sw = sr + 2 * kT * N;
    const float* sv = sr + 3 * kT * N;
    const float* sd = sr + 4 * kT * N;
    exp_own<float, N>(sw, sw, vec, tid);
    __syncthreads();                     // chunk c staged, w = exp(logw)
    for (int t = warp; t < kT; t += W) {   // do_t . v_t
      float a = 0.f;
      for (int j = lane; j < N; j += 32) a = fmaf(sd[t * N + j], sv[t * N + j], a);
      a = repro::warp_sum(a);
      if (lane == 0) dov_s[t] = a;
    }
    __syncthreads();

    // the states before each sub-chunk, from the one before the chunk
    float Ss[kT / kSub][RPT][kJC];
    const float* sc0 = st_head + (long long)c * N * N + j0;
#pragma unroll
    for (int ii = 0; ii < RPT; ++ii) {
      const float2 f =
          *reinterpret_cast<const float2*>(sc0 + (q * RPT + ii) * N);
      Ss[0][ii][0] = f.x;
      Ss[0][ii][1] = f.y;
    }
    auto advance = [&](const float (&from)[RPT][kJC], float (&to)[RPT][kJC],
                       int tl) {
      float kk[RPT], ww[RPT], vv[kJC];
      load_row(sk + tl * N + q * RPT, kk);
      load_row(sw + tl * N + q * RPT, ww);
      load_row(sv + tl * N + j0, vv);
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii)
#pragma unroll
        for (int c2 = 0; c2 < kJC; ++c2)
          to[ii][c2] = fmaf(ww[ii], from[ii][c2], kk[ii] * vv[c2]);
    };
#pragma unroll
    for (int sc = 1; sc < kT / kSub; ++sc) {
      float S[RPT][kJC];
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii)
#pragma unroll
        for (int c2 = 0; c2 < kJC; ++c2) S[ii][c2] = Ss[sc - 1][ii][c2];
#pragma unroll
      for (int d = 0; d < kSub; ++d) {
        float nx[RPT][kJC];
        advance(S, nx, (sc - 1) * kSub + d);
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii)
#pragma unroll
          for (int c2 = 0; c2 < kJC; ++c2) S[ii][c2] = nx[ii][c2];
      }
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii)
#pragma unroll
        for (int c2 = 0; c2 < kJC; ++c2) Ss[sc][ii][c2] = S[ii][c2];
    }

#pragma unroll
    for (int sc = kT / kSub - 1; sc >= 0; --sc) {
      float Sb[kSub][RPT][kJC];          // Sb[d]: the state before token d
#pragma unroll
      for (int ii = 0; ii < RPT; ++ii)
#pragma unroll
        for (int c2 = 0; c2 < kJC; ++c2) Sb[0][ii][c2] = Ss[sc][ii][c2];
#pragma unroll
      for (int d = 0; d + 1 < kSub; ++d)
        advance(Sb[d], Sb[d + 1], sc * kSub + d);
      float p[kR];                       // dv partials, p[step * kJC + col]
#pragma unroll
      for (int d = kSub - 1; d >= 0; --d) {
        const int tl = sc * kSub + d;
        float rr[RPT], kk[RPT], ww[RPT], vv[kJC], dd[kJC];
        load_row(sr + tl * N + q * RPT, rr);
        load_row(sk + tl * N + q * RPT, kk);
        load_row(sw + tl * N + q * RPT, ww);
        load_row(sv + tl * N + j0, vv);
        load_row(sd + tl * N + j0, dd);
        const float dov = dov_s[tl];
        float ruk = 0.f;
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii) ruk = fmaf(rr[ii] * uu[ii], kk[ii], ruk);
#pragma unroll
        for (int c2 = 0; c2 < kJC; ++c2) {
          float a = 0.f;
#pragma unroll
          for (int ii = 0; ii < RPT; ++ii) a = fmaf(G[ii][c2], kk[ii], a);
          p[d * kJC + c2] = fmaf(ruk, dd[c2], a);
        }
        float pr[RPT], pk[RPT], pw[RPT];
#pragma unroll
        for (int ii = 0; ii < RPT; ++ii) {
          float a = 0.f, b = 0.f, e = 0.f;
#pragma unroll
          for (int c2 = 0; c2 < kJC; ++c2) {
            a = fmaf(dd[c2], Sb[d][ii][c2], a);
            b = fmaf(G[ii][c2], vv[c2], b);
            e = fmaf(G[ii][c2], Sb[d][ii][c2], e);
          }
          // the warp's two column groups
          pr[ii] = a + __shfl_xor_sync(0xffffffffu, a, kR);
          pk[ii] = b + __shfl_xor_sync(0xffffffffu, b, kR);
          pw[ii] = e + __shfl_xor_sync(0xffffffffu, e, kR);
          du[ii] = fmaf(rr[ii] * kk[ii], dov, du[ii]);
#pragma unroll
          for (int c2 = 0; c2 < kJC; ++c2)
            G[ii][c2] = fmaf(ww[ii], G[ii][c2], rr[ii] * dd[c2]);
        }
        if (lane < kR) {
          float* rd = red + (d * 3 * W + warp) * N + q * RPT;
          store_row(rd, pr);
          store_row(rd + W * N, pk);
          store_row(rd + 2 * W * N, pw);
        }
      }
      // dv: lane q holds step q / kJC's value of column q % kJC
      const float dvq = sum_transposed<kR / 2>(p, q);
      const int tq = c * kT + sc * kSub + q / kJC;
      if (tq < seq)
        dv[((long long)(ib * seq + tq) * heads + ih) * N + j0 + q % kJC] = dvq;
      __syncthreads();                   // the warps' row partials written
      for (int idx = tid; idx < kSub * 3 * N; idx += NT) {
        const int d = idx / (3 * N), rest = idx - d * 3 * N;
        const int which = rest / N, i = rest - which * N;
        const int t = c * kT + sc * kSub + d;
        if (t >= seq) continue;
        const float* rp = red + (d * 3 + which) * W * N + i;
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) a += rp[w * N];
        const int tl = sc * kSub + d;
        const long long o = ((long long)(ib * seq + t) * heads + ih) * N + i;
        if (which == 0) {
          if (jb == 0) a = fmaf(u[ih * N + i] * sk[tl * N + i], dov_s[tl], a);
          out_r[o] = a;
        } else if (which == 1) {
          if (jb == 0) a = fmaf(u[ih * N + i] * sr[tl * N + i], dov_s[tl], a);
          out_k[o] = a;
        } else {
          out_w[o] = sw[tl * N + i] * a;
        }
      }
      __syncthreads();                   // red and, after the last, the stage
    }
  }
  repro::cp_async_wait<0>();
  if (jb == 0 && cg == 0) store_row(du_part + q * RPT, du);
  if (ds0 != nullptr) {
#pragma unroll
    for (int ii = 0; ii < RPT; ++ii)
      *reinterpret_cast<float2*>(ds0 + sbase + (q * RPT + ii) * N + j0) =
          make_float2(G[ii][0], G[ii][1]);
  }
}

// dr, dk, dlogw += the workspace's splits, in order; du = the batch rows'
// partials summed in order
__global__ void wkv_bwd_finish(float* __restrict__ dr, float* __restrict__ dk,
                               float* __restrict__ dlogw,
                               float* __restrict__ du,
                               const float* __restrict__ ws, int splits,
                               long long total, int batch, int hn) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long e = first; splits > 1 && e < total; e += stride) {
    float a = dr[e], b = dk[e], c = dlogw[e];
    for (int sp = 0; sp < splits - 1; ++sp) {
      const float* p = ws + (long long)sp * 3 * total + e;
      a += p[0];
      b += p[total];
      c += p[2 * total];
    }
    dr[e] = a;
    dk[e] = b;
    dlogw[e] = c;
  }
  const float* part = ws + (long long)(splits - 1) * 3 * total;
  for (long long e = first; e < hn; e += stride) {
    float a = 0.f;
    for (int ib = 0; ib < batch; ++ib) a += part[(long long)ib * hn + e];
    du[e] = a;
  }
}

template <int N>
int launch_bwd(const float* r, const float* k, const float* v,
               const float* logw, const float* u, const float* dout,
               const float* ds, const float* states, float* dr, float* dk,
               float* dv, float* dlogw, float* du, float* ds0, float* ws,
               int b, int h, int seq, Strides rs, Strides ks, Strides vs,
               Strides wst, Strides dos, cudaStream_t stream) {
  using C = BwdCfg<N>;
  const bool vec = aligned16(r, 4, rs) && aligned16(k, 4, ks) &&
                   aligned16(v, 4, vs) && aligned16(logw, 4, wst) &&
                   aligned16(dout, 4, dos);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd<N><<<dim3(C::kSplit, h, b), C::kThreads, C::kSmem, stream>>>(
      r, k, v, logw, u, dout, ds, states, dr, dk, dv, dlogw, ds0, ws, h, seq,
      rs, ks, vs, wst, dos, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)b * seq * h * N;
  const long long work = C::kSplit > 1 ? total : (long long)h * N;
  const int blocks = (int)std::min<long long>((work + 255) / 256, 1056);
  wkv_bwd_finish<<<blocks, 256, 0, stream>>>(dr, dk, dlogw, du, ws,
                                             C::kSplit, total, b, h * N);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (ctypes).  r, k, v, logw: (b, s, h, n) of one dtype, n
// contiguous, any other strides; u: contiguous (h, n) fp32; s0: contiguous
// (b, h, n, n) fp32 or null; o: (b, s, h, n) in the inputs' dtype, its
// pointer and strides 16-byte aligned (it is written 16 bytes a thread);
// s_out: contiguous (b, h, n, n) fp32; states: contiguous (b, h,
// ceil(s / 32), n, n) fp32, the state before every 32-token chunk, or null
// (the serving paths).  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for an n / dtype no instance takes or an
// unaligned o.
extern "C" int repro_rwkv6_wkv(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* s0, void* o, void* s_out, void* states,
    int b, int h, int seq, int n, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long w_sb,
    long long w_ss, long long w_sh, long long o_sb, long long o_ss,
    long long o_sh, int dtype, void* stream) {
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, ws{w_sb, w_ss, w_sh}, os{o_sb, o_ss, o_sh};
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  float* stf = static_cast<float*>(states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_n<float>(n, r, k, v, logw, uf, s0f, o, sof, stf, b, h,
                             seq, rs, ks, vs, ws, os, st);
  if (dtype == repro::kBF16)
    return dispatch_n<__nv_bfloat16>(n, r, k, v, logw, uf, s0f, o, sof, stf,
                                     b, h, seq, rs, ks, vs, ws, os, st);
  return repro::kUnsupported;
}

// C entry point (ctypes) of the reverse, fp32 only.  r, k, v, logw, dout:
// (b, s, h, n), n contiguous, any other strides; u: contiguous (h, n);
// ds: the final state's gradient, contiguous (b, h, n, n), or null
// (zeros); states: the forward's chunk states (b, h, ceil(s / 32), n, n);
// dr, dk, dv, dlogw: contiguous (b, s, h, n); du: (h, n); ds0: (b, h, n,
// n) or null (not wanted); ws: an fp32 workspace of ((n / 32 - 1) x 3 x
// b s h n + b h n) elements at n 64, (b h n) at n 16 and 32.  Two
// launches; returns as ``repro_rwkv6_wkv``.
extern "C" int repro_rwkv6_wkv_bwd(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* dout, const void* ds, const void* states,
    void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0, void* ws,
    int b, int h, int seq, int n, long long r_sb, long long r_ss,
    long long r_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long w_sb,
    long long w_ss, long long w_sh, long long d_sb, long long d_ss,
    long long d_sh, void* stream) {
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, wst{w_sb, w_ss, w_sh}, dos{d_sb, d_ss, d_sh};
  auto in = [](const void* p) { return static_cast<const float*>(p); };
  auto out = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WKV_BWD(N)                                                    \
  launch_bwd<N>(in(r), in(k), in(v), in(logw), in(u), in(dout), in(ds),     \
                in(states), out(dr), out(dk), out(dv), out(dlogw), out(du), \
                out(ds0), out(ws), b, h, seq, rs, ks, vs, wst, dos, st)
  switch (n) {
    case 16: return REPRO_WKV_BWD(16);
    case 32: return REPRO_WKV_BWD(32);
    case 64: return REPRO_WKV_BWD(64);
    default: return repro::kUnsupported;
  }
#undef REPRO_WKV_BWD
}
