// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the causal
// / sliding-window GQA attention of flash_attention.cu, FlashAttention-2
// form, from the forward's output O and its per-row log-sum-exp.
//
// Replaces: no Pallas kernel.  The reference takes its attention gradient
// from XLA's autodiff of src/repro/models/attention.py:52 `attention`; the
// Pallas flash kernel (src/repro/kernels/flash_attention/flash_attention.py
// :70) is forward only.  This computes what jax.grad gives there:
//   D  = rowsum(dO o O)
//   S  = scale Q K^T with the forward's masks, P = exp(S - LSE)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dK = scale dS^T Q,  dQ = scale dS K
// with dK and dV summed over the g query heads of their kv head (query
// head ih reads kv head ih / g).  Masked keys, keys past skv and query
// rows past sq contribute exact zeros (P is set to 0, never computed from
// a masked score), so a fully masked row gives zero gradients, not NaN.
//
// What bounds it on the H100: at smollm-135m's training shape (b 8, 2048
// tokens, hq 9, hkv 3, d 64, causal) one call does ~2.5x the forward's
// matmul flops over the causal half, ~1e11 flops, and moves ~0.1 GB: far
// above the ridge, so operations bound it.  This first version runs them
// on the CUDA cores in fp32 (the bound it is held to is the bf16 tensor
// core rate for bf16 inputs, which it cannot reach); its tensor-core
// redesign is later work.
//
// Two kernels, no atomics, so the result is the same bit for bit on every
// call:
// * `flash_bwd_dq`, one block per (64-row q tile, query head, batch row),
//   runs first.  It computes D for its rows (and writes it to a workspace
//   the second kernel reads), then walks the kv tiles its rows can see
//   (the forward's tile range: from the window's first tile to the causal
//   diagonal), recomputing S, P, dP and dS per tile and accumulating
//   dQ += dS K in registers.
// * `flash_bwd_dkdv`, one block per (64-key kv tile, kv head, batch row),
//   loops over the g query heads of its kv head and over the q tiles whose
//   rows can see a key of the tile (from the causal diagonal to the
//   window's last row), accumulating dV += P^T dO and dK += dS^T Q in
//   registers.
// Every tile is staged in shared memory as fp32 with rows padded by one
// float, so each of the products below reads without bank conflicts
// whichever dimension it walks.  256 threads as a 16 x 16 grid; thread
// (tx, ty) owns rows ty + 16 r and columns tx + 16 s of a 64 x N product
// (a 4 x N/16 register tile), accumulating in fp32.  Inputs are read with
// any (b, h, s) strides and a contiguous head dim, as the forward reads
// them; outputs are written with their own strides.  head_dim 64 and 128.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per tile
constexpr int kBK = 64;                  // keys per tile
constexpr int kThreads = 256;            // 16 x 16
constexpr int kLdP = kBK + 1;            // padded row of a (q, k) tile

struct Strides {
  long long b, h, s;                     // in elements; d is contiguous
};

template <int D>
__host__ __device__ constexpr int ld() {  // padded row of a (row, d) tile
  return D + 1;
}

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int skv,
                                        int causal, int window) {
  return qp < sq && kp < skv && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// rows [r0, r0 + rows) of one head's (s, d) slice into a padded fp32 tile;
// rows past `limit` are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int rows, int limit) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld<D>() + c] =
        r0 + r < limit ? repro::to_f32(src[(long long)(r0 + r) * ss + c])
                       : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for one (q tile, kv tile): thread (tx, ty)
// gets rows ty + 16 r, keys tx + 16 s
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int L = ld<D>();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float q[4], o[4], k[4], v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      q[r] = Qs[(ty + 16 * r) * L + c];
      o[r] = dOs[(ty + 16 * r) * L + c];
      k[r] = Ks[(tx + 16 * r) * L + c];
      v[r] = Vs[(tx + 16 * r) * L + c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = fmaf(q[r], k[j], s[r][j]);
        dp[r][j] = fmaf(o[r], v[j], dp[r][j]);
      }
  }
}

// P and dS of one tile from its scores: P = exp(scale S - LSE) where the
// key is visible (0 elsewhere), dS = P (dP - D)
__device__ __forceinline__ void probs(float (&s)[4][4], float (&dp)[4][4],
                                      const float* lse_s, const float* d_s,
                                      int q0, int k0, int tx, int ty, int sq,
                                      int skv, int causal, int window,
                                      float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok =
          visible(q0 + row, k0 + tx + 16 * j, sq, skv, causal, window);
      const float p = ok ? expf(s[r][j] * scale - lse_s[row]) : 0.f;
      s[r][j] = p;
      dp[r][j] = p * (dp[r][j] - d_s[row]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const float* __restrict__ lse, const T* __restrict__ dout,
             T* __restrict__ dq, float* __restrict__ delta, int g, int sq,
             int skv, Strides qs, Strides ks, Strides vs, Strides os,
             Strides dos, Strides dqs, int causal, int window, float scale) {
  constexpr int L = ld<D>();
  constexpr int DN = D / 16;             // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // kBQ x L
  float* dOs = Qs + kBQ * L;             // kBQ x L
  float* Ks = dOs + kBQ * L;             // kBK x L
  float* Vs = Ks + kBK * L;              // kBK x L
  float* dSs = Vs + kBK * L;             // kBQ x kLdP
  float* lse_s = dSs + kBQ * kLdP;       // kBQ
  float* d_s = lse_s + kBQ;              // kBQ

  const int ih = blockIdx.y, ib = blockIdx.z, hq = gridDim.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const T* qb = q + ib * qs.b + ih * qs.h;
  const T* kb = k + ib * ks.b + (ih / g) * ks.h;
  const T* vb = v + ib * vs.b + (ih / g) * vs.h;
  const T* ob = o + ib * os.b + ih * os.h;
  const T* dob = dout + ib * dos.b + ih * dos.h;
  T* dqb = dq + ib * dqs.b + ih * dqs.h;
  const long long row0 = ((long long)ib * hq + ih) * sq;   // lse / delta

  stage<T, D>(Qs, qb, qs.s, q0, kBQ, sq);
  stage<T, D>(dOs, dob, dos.s, q0, kBQ, sq);
  __syncthreads();
  // D = rowsum(dO o O): warp w takes rows 8 w .. 8 w + 7
  for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < sq)
      for (int c = lane; c < D; c += 32)
        acc += dOs[r * L + c] * repro::to_f32(ob[(long long)qp * os.s + c]);
    acc = repro::warp_sum(acc);
    if (lane == 0) {
      d_s[r] = acc;
      lse_s[r] = qp < sq ? lse[row0 + qp] : 0.f;
      if (qp < sq) delta[row0 + qp] = acc;
    }
  }

  // the kv tiles these rows can see (the forward's range)
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float acc[4][DN];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[r][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                     // last tile consumed; D, LSE set
    stage<T, D>(Ks, kb, ks.s, k0, kBK, skv);
    stage<T, D>(Vs, vb, vs.s, k0, kBK, skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
    probs(s, dp, lse_s, d_s, q0, k0, tx, ty, sq, skv, causal, window, scale);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * r) * kLdP + tx + 16 * j] = dp[r][j];
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float a[4], b[DN];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = dSs[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < DN; ++c) b[c] = Ks[j * L + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty + 16 * r;
    if (qp < sq)
#pragma unroll
      for (int c = 0; c < DN; ++c)
        dqb[(long long)qp * dqs.s + tx + 16 * c] =
            repro::from_f32<T>(acc[r][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv, int g, int sq, int skv,
               Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
               Strides dvs, int causal, int window, float scale) {
  constexpr int L = ld<D>();
  constexpr int DN = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                      // kBK x L
  float* Vs = Ks + kBK * L;              // kBK x L
  float* Qs = Vs + kBK * L;              // kBQ x L
  float* dOs = Qs + kBQ * L;             // kBQ x L
  float* Ps = dOs + kBQ * L;             // kBQ x kLdP
  float* dSs = Ps + kBQ * kLdP;          // kBQ x kLdP
  float* lse_s = dSs + kBQ * kLdP;       // kBQ
  float* d_s = lse_s + kBQ;              // kBQ

  const int hk = blockIdx.y, ib = blockIdx.z, hkv = gridDim.y;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hq = hkv * g;

  stage<T, D>(Ks, k + ib * ks.b + hk * ks.h, ks.s, k0, kBK, skv);
  stage<T, D>(Vs, v + ib * vs.b + hk * vs.h, vs.s, k0, kBK, skv);

  // the q tiles whose rows can see a key of this tile
  const int k_last = min(k0 + kBK, skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_stop = window > 0 ? min(sq, k_last + window) : sq;
  const int t_begin = q_begin / kBQ;
  const int t_end = q_begin < q_stop ? (q_stop + kBQ - 1) / kBQ : t_begin;

  float ak[4][DN], av[4][DN];            // dK, dV: keys ty + 16 r
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DN; ++c) ak[r][c] = av[r][c] = 0.f;

  for (int ih = hk * g; ih < (hk + 1) * g; ++ih) {
    const T* qb = q + ib * qs.b + ih * qs.h;
    const T* dob = dout + ib * dos.b + ih * dos.h;
    const long long row0 = ((long long)ib * hq + ih) * sq;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();                   // last tile consumed
      stage<T, D>(Qs, qb, qs.s, q0, kBQ, sq);
      stage<T, D>(dOs, dob, dos.s, q0, kBQ, sq);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[row0 + q0 + r] : 0.f;
        d_s[r] = in ? delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
      probs(s, dp, lse_s, d_s, q0, k0, tx, ty, sq, skv, causal, window,
            scale);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * r) * kLdP + tx + 16 * j] = s[r][j];
          dSs[(ty + 16 * r) * kLdP + tx + 16 * j] = dp[r][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (the scale applied at the end)
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float p[4], ds[4], o[DN], qq[DN];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p[r] = Ps[i * kLdP + ty + 16 * r];
          ds[r] = dSs[i * kLdP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          o[c] = dOs[i * L + tx + 16 * c];
          qq[c] = Qs[i * L + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DN; ++c) {
            av[r][c] = fmaf(p[r], o[c], av[r][c]);
            ak[r][c] = fmaf(ds[r], qq[c], ak[r][c]);
          }
      }
    }
  }

  T* dkb = dk + ib * dks.b + hk * dks.h;
  T* dvb = dv + ib * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty + 16 * r;
    if (kp < skv)
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        dkb[(long long)kp * dks.s + tx + 16 * c] =
            repro::from_f32<T>(ak[r][c] * scale);
        dvb[(long long)kp * dvs.s + tx + 16 * c] =
            repro::from_f32<T>(av[r][c]);
      }
  }
}

template <int D>
constexpr int smem_dq() {
  return (int)sizeof(float) *
         ((kBQ + kBQ + kBK + kBK) * ld<D>() + kBQ * kLdP + 2 * kBQ);
}

template <int D>
constexpr int smem_dkdv() {
  return (int)sizeof(float) *
         ((kBK + kBK + kBQ + kBQ) * ld<D>() + 2 * kBQ * kLdP + 2 * kBQ);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int b, hq, hkv, sq, skv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int s1 = smem_dq<D>(), s2 = smem_dkdv<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return (int)err;
  const int g = a.hq / a.hkv;
  // dQ first: it writes the D the dK / dV kernel reads
  flash_bwd_dq<T, D><<<dim3((a.sq + kBQ - 1) / kBQ, a.hq, a.b), kThreads, s1,
                       stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o), a.lse,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.delta, g, a.sq,
      a.skv, a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.causal, a.window,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<T, D><<<dim3((a.skv + kBK - 1) / kBK, a.hkv, a.b), kThreads,
                         s2, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lse, a.delta,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), g, a.sq, a.skv, a.qs, a.ks, a.vs, a.dos, a.dks,
      a.dvs, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return repro::kUnsupported;
  }
}

}  // namespace

// C entry point (ctypes).  q, o, dout, dq (b, hq, sq, d); k, v, dk, dv
// (b, hkv, skv, d): any (b, h, s) strides in elements, head dim
// contiguous.  lse and delta (b, hq, sq) contiguous fp32: lse from the
// forward, delta a workspace this call fills with D.  Returns 0, the
// cudaError_t of a refused launch, or -1 for a head_dim / dtype it does
// not take (head_dim 64 and 128; fp32 and bf16).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int b, int hq, int hkv, int sq, int skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, int dtype, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = delta;
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
  a.qs = {q_sb, q_sh, q_ss};
  a.ks = {k_sb, k_sh, k_ss};
  a.vs = {v_sb, v_sh, v_ss};
  a.os = {o_sb, o_sh, o_ss};
  a.dos = {do_sb, do_sh, do_ss};
  a.dqs = {dq_sb, dq_sh, dq_ss};
  a.dks = {dk_sb, dk_sh, dk_ss};
  a.dvs = {dv_sb, dv_sh, dv_ss};
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_d<float>(d, a, st);
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16>(d, a, st);
  return repro::kUnsupported;
}
