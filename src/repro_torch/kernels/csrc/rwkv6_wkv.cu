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
// packed in shared memory) with NT threads; rows at or past `nt` are
// written as zeros.  With `vec`, thread tid copies the 16-byte pieces tid,
// tid + NT, ... of the packed tile, the ones `exp_own` below converts.
template <typename T, int NT, int cols>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int nt,
                                           bool vec, int tid) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    constexpr int cpr = cols / E, kPieces = kT * cpr;
#pragma unroll
    for (int p = 0; p < (kPieces + NT - 1) / NT; ++p) {
      const int idx = tid + p * NT;
      if (kPieces % NT != 0 && idx >= kPieces) break;
      const int t = idx / cpr, ch = idx - t * cpr;
      const bool live = t < nt;
      repro::cp_async_16(dst + idx * E,
                         src + (live ? t : 0) * stride + ch * E,
                         live ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kT * cols; idx += NT) {
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

// w = exp(logw) for the logw of the kT x cols tile that this thread
// staged with NT threads (it has waited for its own copies, so no barrier
// is needed before this): all its pieces are loaded first, then converted
// and stored.
template <typename T, int NT, int cols>
__device__ __forceinline__ void exp_own(float* w, const T* lw, bool vec,
                                        int tid) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    constexpr int kPieces = kT * cols / E;
    constexpr int P = (kPieces + NT - 1) / NT;
    float x[P][E];
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (tid + p * NT < kPieces) unpack16(lw + (tid + p * NT) * E, x[p]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (tid + p * NT >= kPieces) break;
      float* dst = w + (tid + p * NT) * E;
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(expf(x[p][e]), expf(x[p][e + 1]), expf(x[p][e + 2]),
                        expf(x[p][e + 3]));
    }
  } else {
    for (int idx = tid; idx < kT * cols; idx += NT)
      w[idx] = expf(repro::to_f32(lw[idx]));
  }
}

// M consecutive floats of shared memory (16-byte aligned when M % 4 == 0)
template <int M>
__device__ __forceinline__ void load_row(const float* p, float (&x)[M]) {
  if constexpr (M == 2) {                // 8-byte aligned
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else if constexpr (M % 4 == 0) {
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
      stage_rows<T, NT, N>(dst, src + t0 * stride, stride, nt, vec,
                              tid);
    } else {
      stage_rows<T, NT, JB>(dst, vb + t0 * vs.s, vs.s, nt, vec, tid);
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
    exp_own<T, NT, N>(stage_w(st), stage_r(st) + 2 * kT * N, vec, tid);
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
// forward's bits: the sub-chunk starts first (1 and 2 kept in shared
// memory, 3 in registers, 0 read again), then, sub-chunk by sub-chunk from
// the last, its kSub states into registers, walked back in time.
//
// Segments.  G's recurrence is linear and every w lies in [0, 1], so the
// sequence is cut into P segments of whole chunks (``segments``: the
// shape alone decides, about kSegTargetBlocks blocks in the main launch),
// three launches:
//   * ``wkv_bwd_carry``, for segments 1 .. P-1: the segment's part of G
//     from zero, L = sum_t (c_t r_t) do_t^T with c_t the product of the
//     segment's w before t (a running product, forward in time: a thread
//     a row writes c_t r_t over r in shared memory a chunk at a time),
//     and its decay product D = prod w (an n-vector); a block holds a
//     head's n rows, so do is read once;
//   * ``wkv_bwd``: each segment's incoming G, ds (or zeros) joined with the
//     later segments' carries in a fixed order, G <- D G + L from the last;
//     then the reverse above over the segment alone; segment 0 writes ds0;
//   * ``wkv_bwd_finish``: the segments' and batch rows' du partials,
//     summed in order.
// Nothing is divided by a decay (what costs the chunked form ~1e-2 at the
// model's decays): the split changes only the order of the sums.  No
// atomics: two calls give the same bits.
//
// Layout: a block owns RB = 32 rows of a head's state (16 at n 16) and all
// n columns, so the sums over columns (dr, dk, dlogw) end inside it.  Lane
// q of a group of n / 4 lanes holds R rows (2 at n 64, else 1) x 4 columns
// of G and of the states; each step's row partials are halved once over
// the group's two rows at n 64, then summed kSub steps at a time by
// transposed halving, after which each lane adds the per-row terms of its
// (row, step) and writes dr, dk, dlogw.  dv (a sum over rows) goes over a
// warp's row groups by shuffles and over the block's warps through shared
// memory once per kSub steps; at n 64 a head's two row blocks form a
// cluster: each keeps its rows' dv of the chunk (``dvsum``, by chunk
// parity), arrives at the cluster barrier after the chunk and waits on it
// a chunk later, then writes half the columns as its part plus the
// peer's, read from the peer's shared memory (a cluster barrier every
// kSub steps instead stalled the pair more than a fixed-order pass over
// a dv workspace cost).  do_t . v_t and sum_i r u k over the block's rows
// are computed per chunk first, each block adding its rows' share.
// Inputs go through a 2-stage cp.async ring (r, k, logw over the block's
// rows, v and do whole), the chunk before the current one loading while
// it runs.  __launch_bounds__(256, 2) holds the main kernel to 128
// registers with 104 KB of shared memory, so two blocks share an SM: 16
// warps hide the chain's latency.
//
// What bounds it on the H100: at rwkv6-3b's training shape (1, 4096, 40,
// 64) it reads r, k, v, logw, do and the chunk states and writes dr, dk,
// dv, dlogw (0.46 GB, 0.14 ms at 3.35 TB/s) and does ~14 n^2 flops a token
// and head (9.4 GFLOP, 0.14 ms at 67 TFLOP/s fp32).  The real limit is the
// instructions a step issues beside those flops (the recomputed states,
// the shuffles of the sums, shared-memory loads): ~130 a thread and step,
// the time falling with each one removed.  With 13 segments the main
// launch has 1,040 blocks (four waves of 264) and the carry 480; the
// serial chain a block walks is 320 tokens.
// ---------------------------------------------------------------------------

constexpr int kSub = 8;                  // states held in registers
constexpr int kBwdStages = 2;
constexpr int kSegTargetBlocks = 1024;   // the main launch's blocks, about
static_assert(kT % kSub == 0 && kT / kSub >= 3, "sub-chunks");

template <int N>
struct BwdCfg {
  static constexpr int C = 4;                    // state columns a thread
  static constexpr int L = N / C;                // lanes of a row group
  static constexpr int GPW = 32 / L;             // row groups a warp
  static constexpr int R = N == 64 ? 2 : 1;      // state rows a thread
  static constexpr int RB = N < 32 ? N : 32;     // state rows a block
  static constexpr int kWarps = RB / (GPW * R);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowBlocks = N / RB;
  static constexpr int LR = L / R;               // lanes a row's sums span
  static constexpr int V = kSub / LR;            // steps a lane writes
  // one stage: r, k, logw (turned into w in place) over the block's rows,
  // then v and do, kT tokens each
  static constexpr int kStageElems = kT * (3 * RB + 2 * N);
  static constexpr int kSsElems = 2 * R * C * kThreads;    // starts 1, 2
  static constexpr int kDvElems = kSub * kWarps * N;   // dv, by warp
  // a pair's dv of its rows, of the two latest chunks, for the exchange
  static constexpr int kDvSumElems = kRowBlocks > 1 ? 2 * kT * N : 0;
  // + do . v and sum r u k a token
  static constexpr size_t kSmem = (kBwdStages * kStageElems + kSsElems +
                                   kDvElems + kDvSumElems + 2 * kT) *
                                  sizeof(float);
  static_assert(L * GPW == 32 && kWarps * GPW * R == RB && LR <= kSub,
                "layout");
};

// The carry's tile: a block holds all n rows of a head (so do is read
// once), R rows x 4 columns a thread
template <int N>
struct CarryCfg {
  static constexpr int C = 4, L = N / C, GPW = 32 / L;
  static constexpr int kWarps = N < 32 ? 2 : 8;
  static constexpr int R = N / (GPW * kWarps);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStageElems = kT * 3 * N;   // r, logw, do
  static_assert(kWarps * GPW * R == N, "layout");
};

// A head's two row blocks (n 64) form a cluster and sum dv through each
// other's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ const float* cluster_peer(const float* p,
                                                     int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// The segments of a reverse: `count` of `chunks` kT-token chunks each (the
// last may hold fewer).  The sequence is cut into as many parts as bring
// the main launch (row blocks x count x b x h blocks) to kSegTargetBlocks,
// at most one a chunk, each rounded up to whole chunks.  The shape alone
// decides.
struct Segments {
  int count, chunks;
};
Segments segments(int b, int h, int seq, int n) {
  const int chunks = (seq + kT - 1) / kT;
  const int blocks = std::max(1, b * h * (n / std::min(n, 32)));
  const int want = std::max(
      1, std::min(chunks, (kSegTargetBlocks + blocks - 1) / blocks));
  const int per = (chunks + want - 1) / want;
  return {(chunks + per - 1) / per, per};
}

// 4 floats to 16-byte-aligned memory
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// p[0 .. LEN) summed over the lanes q ^ M, q ^ M/2, .. q ^ 1 by transposed
// halving: each level keeps the half that its lane bit selects and adds
// the partner's copy of it, so lane q ends with LEN / 2M sums, those of
// indices (q % 2M) LEN / 2M + m.  One template level per halving, so every
// index is a constant and p stays in registers.
template <int M, int LEN, int K>
__device__ __forceinline__ void halve(float (&p)[K], int q) {
  if constexpr (M >= 1) {
    const bool hi = q & M;
#pragma unroll
    for (int i = 0; i < LEN / 2; ++i)
      p[i] = (hi ? p[i + LEN / 2] : p[i]) +
             __shfl_xor_sync(0xffffffffu, hi ? p[i] : p[i + LEN / 2], M);
    halve<M / 2, LEN / 2>(p, q);
  }
}

// Where the reverse's partials go in its workspace (floats): the carries'
// L, (P - 1) x b h n n; their D, (P - 1) x b h n; du per segment and
// batch row, P x b h n
struct BwdWs {
  float *carry_l, *carry_d, *du_part;
  BwdWs(float* ws, int count, int b, int h, int n) {
    const long long bhn = (long long)b * h * n;
    carry_l = ws;
    carry_d = carry_l + (count - 1) * bhn * n;
    du_part = carry_d + (count - 1) * bhn;
  }
};

template <int N>
__global__ void __launch_bounds__(CarryCfg<N>::kThreads, 4)
wkv_bwd_carry(const float* __restrict__ r, const float* __restrict__ logw,
              const float* __restrict__ dout, float* __restrict__ carry_l,
              float* __restrict__ carry_d, int seq, int cps, Strides rs,
              Strides wst, Strides dos, bool vec) {
  using Cf = CarryCfg<N>;
  constexpr int R = Cf::R, C = Cf::C, L = Cf::L;
  constexpr int NT = Cf::kThreads, SE = Cf::kStageElems;
  static_assert(NT >= N, "a thread a row for the decay products");
  __shared__ __align__(16) float stages[kBwdStages * SE];

  const int seg = blockIdx.x + 1;        // 1 .. P - 1
  const int ih = blockIdx.y, ib = blockIdx.z, heads = gridDim.y;
  const long long head = (long long)ib * heads + ih;
  const long long n_heads = (long long)gridDim.z * heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / L, q = lane % L;
  const int i0 = (warp * Cf::GPW + g) * R, j0 = q * C;
  const int n_chunks = (seq + kT - 1) / kT;
  const int c_lo = seg * cps, c_hi = min(n_chunks, c_lo + cps);
  const float* src[3] = {r + ib * rs.b + ih * rs.h,
                         logw + ib * wst.b + ih * wst.h,
                         dout + ib * dos.b + ih * dos.h};
  const long long sstr[3] = {rs.s, wst.s, dos.s};

  auto stage = [&](int c) {
    const int t0 = c * kT, nt = min(kT, seq - t0);
    float* dst = stages + (c % kBwdStages) * SE;
#pragma unroll
    for (int tile = 0; tile < 3; ++tile)
      stage_rows<float, NT, N>(dst + tile * kT * N,
                               src[tile] + t0 * sstr[tile], sstr[tile], nt,
                               vec, tid);
  };

  float cum = 1.f;                       // row tid's product of w so far
  float lc[R][C];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int c = 0; c < C; ++c) lc[rr][c] = 0.f;
  stage(c_lo);
  repro::cp_async_commit();
  for (int c = c_lo; c < c_hi; ++c) {
    repro::cp_async_wait<0>();           // this thread's part of chunk c
    float* sa = stages + (c % kBwdStages) * SE;    // r, turned into c_t r_t
    float* sw = sa + kT * N;
    const float* sd = sa + 2 * kT * N;
    exp_own<float, NT, N>(sw, sw, vec, tid);
    __syncthreads();                     // chunk c staged; c - 1 is done
    if (c + 1 < c_hi) stage(c + 1);
    repro::cp_async_commit();
    if (tid < N) {                       // rows past the end: r 0, w 1
#pragma unroll 8
      for (int t = 0; t < kT; ++t) {
        sa[t * N + tid] *= cum;
        cum *= sw[t * N + tid];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < kT; ++t) {
      float aa[R], dd[C];
      load_row(sa + t * N + i0, aa);
      load_row(sd + t * N + j0, dd);
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int c2 = 0; c2 < C; ++c2)
          lc[rr][c2] = fmaf(aa[rr], dd[c2], lc[rr][c2]);
    }
  }
  repro::cp_async_wait<0>();
  const long long slot = (long long)(seg - 1) * n_heads + head;
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    store4(carry_l + (slot * N + i0 + rr) * N + j0, lc[rr]);
  if (tid < N) carry_d[slot * N + tid] = cum;
}

template <int N>
__global__ void __launch_bounds__(BwdCfg<N>::kThreads, 2)
wkv_bwd(const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ logw,
        const float* __restrict__ u, const float* __restrict__ dout,
        const float* __restrict__ ds, const float* __restrict__ states,
        const float* __restrict__ carry_l, const float* __restrict__ carry_d,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dlogw,
        float* __restrict__ ds0, float* __restrict__ du_part, int seq,
        int cps, Strides rs, Strides ks, Strides vs, Strides wst,
        Strides dos, bool vec) {
  using Cf = BwdCfg<N>;
  constexpr int R = Cf::R, C = Cf::C, L = Cf::L, RB = Cf::RB, LR = Cf::LR;
  constexpr int NT = Cf::kThreads, W = Cf::kWarps, V = Cf::V;
  constexpr int SE = Cf::kStageElems, kSubs = kT / kSub;
  constexpr bool kPair = Cf::kRowBlocks > 1;   // a cluster of two
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  float* ss = stages + kBwdStages * SE;  // sub-chunk starts 1, 2
  float* dvbuf = ss + Cf::kSsElems;
  float* dvsum = dvbuf + Cf::kDvElems;
  float* dov_s = dvsum + Cf::kDvSumElems;   // do_t . v_t
  float* ruk_s = dov_s + kT;             // sum_i r u k over the block's rows

  const int rb = blockIdx.x % Cf::kRowBlocks;
  const int seg = blockIdx.x / Cf::kRowBlocks;
  const int n_segs = gridDim.x / Cf::kRowBlocks;
  const int ih = blockIdx.y, ib = blockIdx.z, heads = gridDim.y;
  const long long head = (long long)ib * heads + ih;
  const long long n_heads = (long long)gridDim.z * heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / L, q = lane % L;
  const int il0 = (warp * Cf::GPW + g) * R;   // this thread's first row
  const int i0 = rb * RB + il0, j0 = q * C;
  const int orow = il0 + q / LR;         // the row this lane's sums end on
  const int n_chunks = (seq + kT - 1) / kT;
  const int c_lo = seg * cps, c_hi = min(n_chunks, c_lo + cps);
  const long long sbase = head * N * N;
  const float* st_head = states + head * n_chunks * N * N;
  const float* src[5] = {r + ib * rs.b + ih * rs.h + rb * RB,
                         k + ib * ks.b + ih * ks.h + rb * RB,
                         logw + ib * wst.b + ih * wst.h + rb * RB,
                         v + ib * vs.b + ih * vs.h,
                         dout + ib * dos.b + ih * dos.h};
  const long long sstr[5] = {rs.s, ks.s, wst.s, vs.s, dos.s};
  const float uo = u[ih * N + rb * RB + orow];

  // G entering the segment: ds (or zeros) joined with the later segments'
  // carries, the last first
  float G[R][C];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    if (ds != nullptr) {
      const float4 f =
          *reinterpret_cast<const float4*>(ds + sbase + (i0 + rr) * N + j0);
      G[rr][0] = f.x, G[rr][1] = f.y, G[rr][2] = f.z, G[rr][3] = f.w;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) G[rr][c] = 0.f;
    }
  }
#pragma unroll 4
  for (int sg = n_segs - 1; sg > seg; --sg) {
    const long long slot = (long long)(sg - 1) * n_heads + head;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float d = carry_d[slot * N + i0 + rr];
      const float4 l = *reinterpret_cast<const float4*>(
          carry_l + (slot * N + i0 + rr) * N + j0);
      G[rr][0] = fmaf(d, G[rr][0], l.x);
      G[rr][1] = fmaf(d, G[rr][1], l.y);
      G[rr][2] = fmaf(d, G[rr][2], l.z);
      G[rr][3] = fmaf(d, G[rr][3], l.w);
    }
  }

  auto stage = [&](int c) {
    const int t0 = c * kT, nt = min(kT, seq - t0);
    float* dst = stages + (c % kBwdStages) * SE;
#pragma unroll
    for (int tile = 0; tile < 3; ++tile)
      stage_rows<float, NT, RB>(dst + tile * kT * RB,
                                src[tile] + t0 * sstr[tile], sstr[tile], nt,
                                vec, tid);
#pragma unroll
    for (int tile = 3; tile < 5; ++tile)
      stage_rows<float, NT, N>(dst + 3 * kT * RB + (tile - 3) * kT * N,
                               src[tile] + t0 * sstr[tile], sstr[tile], nt,
                               vec, tid);
  };
  auto load_state = [&](const float* p, float (&S)[R][C]) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float4 f =
          *reinterpret_cast<const float4*>(p + (i0 + rr) * N + j0);
      S[rr][0] = f.x, S[rr][1] = f.y, S[rr][2] = f.z, S[rr][3] = f.w;
    }
  };

  // a pair's dv of chunk cc: rank 0's part plus rank 1's, each block
  // writing half the columns
  auto pair_dv = [&](int cc) {
    const float* mine = dvsum + (cc & 1) * kT * N;
    const float* part0 = rb == 0 ? mine : cluster_peer(mine, 0);
    const float* part1 = rb == 1 ? mine : cluster_peer(mine, 1);
    constexpr int H = N / 2;
    for (int idx = tid; idx < kT * H; idx += NT) {
      const int tl = idx / H, j = rb * H + idx - tl * H, t = cc * kT + tl;
      if (t < seq)
        dv[((long long)(ib * seq + t) * heads + ih) * N + j] =
            part0[tl * N + j] + part1[tl * N + j];
    }
  };

  float du_acc = 0.f;
  stage(c_hi - 1);
  repro::cp_async_commit();
  for (int c = c_hi - 1; c >= c_lo; --c) {
    repro::cp_async_wait<0>();           // this thread's part of chunk c
    float* sr = stages + (c % kBwdStages) * SE;
    const float* sk = sr + kT * RB;
    float* sw = sr + 2 * kT * RB;
    const float* sv = sr + 3 * kT * RB;
    const float* sd = sv + kT * N;
    exp_own<float, NT, RB>(sw, sw, vec, tid);
    __syncthreads();   // chunk c staged, w = exp(logw); chunk c + 1 is done
    if (c > c_lo) stage(c - 1);
    repro::cp_async_commit();
    for (int t = warp; t < kT; t += W) {
      float a = 0.f, b = 0.f;
      for (int j = lane; j < N; j += 32)
        a = fmaf(sd[t * N + j], sv[t * N + j], a);
      for (int i = lane; i < RB; i += 32)
        b = fmaf(sr[t * RB + i] * u[ih * N + rb * RB + i], sk[t * RB + i], b);
      a = repro::warp_sum(a);
      b = repro::warp_sum(b);
      if (lane == 0) dov_s[t] = a, ruk_s[t] = b;
    }
    __syncthreads();

    auto advance = [&](const float (&from)[R][C], float (&to)[R][C], int tl) {
      float kk[R], ww[R], vv[C];
      load_row(sk + tl * RB + il0, kk);
      load_row(sw + tl * RB + il0, ww);
      load_row(sv + tl * N + j0, vv);
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int c2 = 0; c2 < C; ++c2)
          to[rr][c2] = fmaf(ww[rr], from[rr][c2], kk[rr] * vv[c2]);
    };
    // the sub-chunk starts, from the state before the chunk (the forward's):
    // 1 and 2 into shared memory (each thread its own), 3 kept in S
    const float* sc0 = st_head + (long long)c * N * N;
    float S[R][C];
    load_state(sc0, S);
#pragma unroll 1
    for (int sc = 1; sc < kSubs; ++sc) {
#pragma unroll
      for (int d = 0; d < kSub; ++d) {
        float nx[R][C];
        advance(S, nx, (sc - 1) * kSub + d);
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2) S[rr][c2] = nx[rr][c2];
      }
      if (sc < kSubs - 1) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2)
            ss[(((sc - 1) * R + rr) * C + c2) * NT + tid] = S[rr][c2];
      }
    }

    // one sub-chunk from its start: its states, then the steps backwards
    auto walk = [&](int sc, const float (&start)[R][C]) {
      float Sb[kSub][R][C];              // Sb[d]: the state before token d
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
#pragma unroll
        for (int c2 = 0; c2 < C; ++c2) Sb[0][rr][c2] = start[rr][c2];
#pragma unroll
      for (int d = 0; d + 1 < kSub; ++d)
        advance(Sb[d], Sb[d + 1], sc * kSub + d);
      float pr[kSub], pk[kSub], pw[kSub];    // row partials by step
#pragma unroll
      for (int d = kSub - 1; d >= 0; --d) {
        const int tl = sc * kSub + d;
        float rr_[R], kk[R], ww[R], vv[C], dd[C];
        load_row(sr + tl * RB + il0, rr_);
        load_row(sk + tl * RB + il0, kk);
        load_row(sw + tl * RB + il0, ww);
        load_row(sv + tl * N + j0, vv);
        load_row(sd + tl * N + j0, dd);
        // dv: over this thread's rows, then the warp's row groups
        float pv[C];
#pragma unroll
        for (int c2 = 0; c2 < C; ++c2) {
          float a = G[0][c2] * kk[0];
#pragma unroll
          for (int rr = 1; rr < R; ++rr) a = fmaf(G[rr][c2], kk[rr], a);
          pv[c2] = a;
        }
#pragma unroll
        for (int m = 16; m >= L; m /= 2)
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2)
            pv[c2] += __shfl_xor_sync(0xffffffffu, pv[c2], m);
        if (g == 0) store4(dvbuf + (d * W + warp) * N + j0, pv);
        // dr, dk, dlogw over this thread's columns; then G <- w G + r do^T
        float x[3][R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          float a = 0.f, b = 0.f, e = 0.f;
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2) {
            a = fmaf(dd[c2], Sb[d][rr][c2], a);
            b = fmaf(G[rr][c2], vv[c2], b);
            e = fmaf(G[rr][c2], Sb[d][rr][c2], e);
          }
          x[0][rr] = a, x[1][rr] = b, x[2][rr] = e;
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2)
            G[rr][c2] = fmaf(ww[rr], G[rr][c2], rr_[rr] * dd[c2]);
        }
        if constexpr (R == 2) {          // the group's two rows: one halving
          const bool hi = q & (L / 2);
#pragma unroll
          for (int z = 0; z < 3; ++z)
            x[z][0] = (hi ? x[z][1] : x[z][0]) +
                      __shfl_xor_sync(0xffffffffu, hi ? x[z][0] : x[z][1],
                                      L / 2);
        }
        pr[d] = x[0][0], pk[d] = x[1][0], pw[d] = x[2][0];
      }
      halve<LR / 2, kSub>(pr, q);
      halve<LR / 2, kSub>(pk, q);
      halve<LR / 2, kSub>(pw, q);
      // lane q holds row orow's sums of steps (q % LR) V + m
#pragma unroll
      for (int m = 0; m < V; ++m) {
        const int tl = sc * kSub + (q % LR) * V + m, t = c * kT + tl;
        if (t < seq) {
          const float rv = sr[tl * RB + orow], kv = sk[tl * RB + orow];
          const float dov = dov_s[tl];
          const long long o =
              ((long long)(ib * seq + t) * heads + ih) * N + rb * RB + orow;
          dr[o] = fmaf(uo * kv, dov, pr[m]);
          dk[o] = fmaf(uo * rv, dov, pk[m]);
          dlogw[o] = sw[tl * RB + orow] * pw[m];
          du_acc = fmaf(rv * kv, dov, du_acc);
        }
      }
      // dv: the warps' partials summed in order, plus do_t sum_i r u k over
      // the block's rows; a pair keeps its part of the chunk for the
      // exchange
      __syncthreads();                   // the warps' partials written
      for (int idx = tid; idx < kSub * N; idx += NT) {
        const int d = idx / N, j = idx - d * N;
        const int tl = sc * kSub + d, t = c * kT + tl;
        const float* p = dvbuf + d * W * N + j;
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) a += p[w * N];
        a = fmaf(sd[tl * N + j], ruk_s[tl], a);
        if constexpr (kPair)
          dvsum[((c & 1) * kT + tl) * N + j] = a;
        else if (t < seq)
          dv[((long long)(ib * seq + t) * heads + ih) * N + j] = a;
      }
      __syncthreads();                   // dvbuf is free again
    };
    // the pair's exchange of chunk c + 1: the peer arrived after its part,
    // a chunk ago; we arrive after chunk c's, below
    if constexpr (kPair) {
      if (c < c_hi - 1) {
        cluster_wait();
        pair_dv(c + 1);
      }
    }
    walk(kSubs - 1, S);
#pragma unroll 1
    for (int sc = kSubs - 2; sc >= 0; --sc) {
      float start[R][C];
      if (sc == 0) {
        load_state(sc0, start);
      } else {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
#pragma unroll
          for (int c2 = 0; c2 < C; ++c2)
            start[rr][c2] = ss[(((sc - 1) * R + rr) * C + c2) * NT + tid];
      }
      walk(sc, start);
    }
    if constexpr (kPair) cluster_arrive();
  }
  repro::cp_async_wait<0>();
  if constexpr (kPair) {
    cluster_wait();
    pair_dv(c_lo);
  }
  // du: this lane's (row, step) terms, summed over the lanes of its row
#pragma unroll
  for (int m = LR / 2; m >= 1; m /= 2)
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, m);
  if (q % LR == 0)
    du_part[((long long)seg * n_heads + head) * N + rb * RB + orow] = du_acc;
  if (seg == 0 && ds0 != nullptr) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      store4(ds0 + sbase + (i0 + rr) * N + j0, G[rr]);
  }
  if constexpr (kPair) {                 // the peer is done with our memory
    cluster_arrive();
    cluster_wait();
  }
}

// du = the segments' and batch rows' partials summed in order
__global__ void wkv_bwd_finish(float* __restrict__ du,
                               const float* __restrict__ du_part, int rows,
                               int hn) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= hn) return;
  float a = 0.f;
  for (int i = 0; i < rows; ++i) a += du_part[(long long)i * hn + e];
  du[e] = a;
}

// The main kernel's shared memory: above 48 KB, and room for two blocks
// an SM
template <int N>
cudaError_t bwd_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BwdCfg<N>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(wkv_bwd<N>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int N>
int launch_bwd(const float* r, const float* k, const float* v,
               const float* logw, const float* u, const float* dout,
               const float* ds, const float* states, float* dr, float* dk,
               float* dv, float* dlogw, float* du, float* ds0, float* ws,
               int b, int h, int seq, Strides rs, Strides ks, Strides vs,
               Strides wst, Strides dos, cudaStream_t stream) {
  using Cf = BwdCfg<N>;
  const bool vec = aligned16(r, 4, rs) && aligned16(k, 4, ks) &&
                   aligned16(v, 4, vs) && aligned16(logw, 4, wst) &&
                   aligned16(dout, 4, dos);
  const Segments sg = segments(b, h, seq, N);
  const BwdWs w(ws, sg.count, b, h, N);
  cudaError_t err;
  if (sg.count > 1) {
    wkv_bwd_carry<N><<<dim3(sg.count - 1, h, b), CarryCfg<N>::kThreads, 0,
                       stream>>>(r, logw, dout, w.carry_l, w.carry_d, seq,
                                 sg.chunks, rs, wst, dos, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = bwd_attributes<N>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sg.count * Cf::kRowBlocks, h, b);
  cfg.blockDim = dim3(Cf::kThreads);
  cfg.dynamicSmemBytes = Cf::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = Cf::kRowBlocks;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv_bwd<N>, r, k, v, logw, u, dout, ds,
                           states, (const float*)w.carry_l,
                           (const float*)w.carry_d, dr, dk, dv, dlogw, ds0,
                           w.du_part, seq, sg.chunks, rs, ks, vs, wst, dos,
                           vec);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_finish<<<(h * N + 255) / 256, 256, 0, stream>>>(
      du, w.du_part, sg.count * b, h * N);
  return (int)cudaGetLastError();
}

// What the main launch gets on this card (for the smoke's report)
template <int N>
int bwd_info(int b, int h, int seq, int* out) {
  using Cf = BwdCfg<N>;
  cudaError_t err = bwd_attributes<N>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, wkv_bwd<N>);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wkv_bwd<N>, Cf::kThreads, Cf::kSmem);
  if (err != cudaSuccess) return (int)err;
  const Segments sg = segments(b, h, seq, N);
  out[0] = sg.count;
  out[1] = sg.chunks;
  out[2] = sg.count * Cf::kRowBlocks * h * b;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = (int)Cf::kSmem;
  return 0;
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
// n) or null (not wanted); ws: an fp32 workspace of (P - 1) x b h n (n +
// 1) + P x b h n elements, plus b s h n at n 64, with P the segments
// (``segments`` above).  Three launches (two when P is 1); returns as
// ``repro_rwkv6_wkv``.
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

// What the reverse's main launch gets for a shape on this card: out[0..6]
// = segments, chunks a segment, blocks, blocks resident on an SM,
// registers a thread, local (spill) bytes a thread, dynamic shared memory
// bytes a block.  Returns as ``repro_rwkv6_wkv``.
extern "C" int repro_rwkv6_wkv_bwd_info(int b, int h, int seq, int n,
                                        int* out) {
  switch (n) {
    case 16: return bwd_info<16>(b, h, seq, out);
    case 32: return bwd_info<32>(b, h, seq, out);
    case 64: return bwd_info<64>(b, h, seq, out);
    default: return repro::kUnsupported;
  }
}
