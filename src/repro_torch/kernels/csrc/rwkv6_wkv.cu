// RWKV-6 WKV recurrence for Hopper (sm_90a), serial form.
//
// Replaces: src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py, `rwkv6_wkv_kernel`
// (the Pallas TPU kernel, pl.pallas_call at :78).  Per (batch row, head),
// with an n x n fp32 state S:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- exp(logw_t[i]) * S[i][j] + k_t[i] * v_t[j]
// Unlike the TPU kernel it starts from a given state s0 (b, h, n, n)
// (null = zeros), returns the final state, and takes any sequence length
// (the TPU kernel needs s % 64 == 0), as the model's time mix needs
// (src/repro/models/rwkv.py:149-153).  It keeps the serial recurrence and
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
        T* __restrict__ o, float* __restrict__ s_out, int heads, int seq,
        Strides rs, Strides ks, Strides vs, Strides ws, Strides os,
        bool vec) {
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
           const float* u, const float* s0, void* o, float* s_out, int b,
           int h, int seq, Strides rs, Strides ks, Strides vs, Strides ws,
           Strides os, cudaStream_t stream) {
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
      static_cast<T*>(o), s_out, h, seq, rs, ks, vs, ws, os, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int n, const void* r, const void* k, const void* v,
               const void* logw, const float* u, const float* s0, void* o,
               float* s_out, int b, int h, int seq, Strides rs, Strides ks,
               Strides vs, Strides ws, Strides os, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, s0, o, s_out, b, h, seq, rs, ks,
                           vs, ws, os, stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, o, s_out, b, h, seq, rs, ks,
                           vs, ws, os, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, o, s_out, b, h, seq, rs, ks,
                           vs, ws, os, stream);
    default:
      return repro::kUnsupported;
  }
}

}  // namespace

// C entry point (ctypes).  r, k, v, logw: (b, s, h, n) of one dtype, n
// contiguous, any other strides; u: contiguous (h, n) fp32; s0: contiguous
// (b, h, n, n) fp32 or null; o: (b, s, h, n) in the inputs' dtype, its
// pointer and strides 16-byte aligned (it is written 16 bytes a thread);
// s_out: contiguous (b, h, n, n) fp32.  Returns 0 on success, the
// cudaError_t of a refused launch, or -1 for an n / dtype no instance
// takes or an unaligned o.
extern "C" int repro_rwkv6_wkv(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* s0, void* o, void* s_out, int b, int h,
    int seq, int n, long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long w_sb, long long w_ss,
    long long w_sh, long long o_sb, long long o_ss, long long o_sh,
    int dtype, void* stream) {
  const Strides rs{r_sb, r_ss, r_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, ws{w_sb, w_ss, w_sh}, os{o_sb, o_ss, o_sh};
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_n<float>(n, r, k, v, logw, uf, s0f, o, sof, b, h, seq, rs,
                             ks, vs, ws, os, st);
  if (dtype == repro::kBF16)
    return dispatch_n<__nv_bfloat16>(n, r, k, v, logw, uf, s0f, o, sof, b, h,
                                     seq, rs, ks, vs, ws, os, st);
  return repro::kUnsupported;
}
