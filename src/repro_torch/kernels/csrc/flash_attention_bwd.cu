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
// matmul flops over the causal half (~1e11; the 7 products the kernels
// run, S and dP recomputed in both, 1.35e11) and moves ~0.1 GB: far above
// the ridge, so operations bound it; so at recurrentgemma-2b's (1 x 4096
// tokens, hq 10, hkv 1, d 256, causal with a 2048 window: 6,292,480
// visible pairs), 1.61e11 flops, 0.163 ms at 989 TFLOP/s.  Both
// instances keep the same form:
// two kernels, no atomics, so the result is the same bit for bit on every
// call.  The dQ kernel, one block per (64-row q tile, query head, batch
// row), runs first: it computes D for its rows (and writes it to a
// workspace the second kernel reads), then walks the kv tiles its rows
// can see (the forward's range: from the window's first tile to the
// causal diagonal), recomputing S, P, dP and dS per tile and accumulating
// dQ += dS K.  The dK / dV kernel, one block per (64-key kv tile, kv
// head, batch row), loops over the g query heads of its kv head and over
// the q tiles whose rows can see a key of the tile (from the causal
// diagonal to the window's last row), accumulating dV += P^T dO and
// dK += dS^T Q.
//
// * `flash_bwd_dq_tc` / `flash_bwd_dkdv_tc`, bf16 at d 64, 128 and 256
//   (FlashAttention-2's backward on mma.sync): every product runs on the
//   tensor cores (m16n8k16, bf16 operands, fp32 accumulators), so the
//   limit is the tensor pipe and the shared-memory reads that feed it
//   (every warp reads its fragments itself: about one ldmatrix.x4 per two
//   MMAs).  Four warps a block, each owning 16 rows of the output it
//   accumulates (query rows in the dQ kernel, keys in the dK / dV kernel)
//   in registers, with those rows' A fragments (Q and dO, resp. K and V)
//   re-read from shared memory per tile: that leaves room for three
//   blocks an SM at d 64 (registers capped at 168 a thread), which
//   measured faster than two blocks holding the fragments in registers.
//   At d 128 dK and dV take 128 accumulator registers a lane, so the
//   dK / dV kernel streams 32-row q tiles to keep S^T and dP^T at 32.
//   At d 256 (recurrentgemma-2b's MQA: 10 query heads on one kv head)
//   a lane's dQ alone takes 128 accumulator registers, so the dQ kernel
//   streams 32-key tiles (its shared memory 160 KB: one block an SM);
//   dK and dV over 256 columns would take 256, so the dK / dV block has
//   two warpgroups (256 threads) that load each Q and dO tile once, each
//   recomputing S^T and dP^T of its 64 keys over the whole head dim and
//   accumulating dK and dV for one half of the columns (1.5x the
//   kernel's products, against the two blocks a split over the grid
//   would take, each loading the same tiles); 128 KB of shared memory.
//   The other operand's tiles (K and V, resp. Q, dO and their rows' LSE
//   and D) stream into XOR-swizzled shared memory through a
//   double-buffered cp.async ring, rows past the end zero-filled by the
//   copy, so tile t + 1 loads while tile t is multiplied.  The dQ kernel computes S = Q K^T and dP =
//   dO V^T with K and V through plain ldmatrix, P and dS on the
//   accumulator fragments, and dQ += dS K with dS packed to bf16 in
//   registers as the A operand and K through ldmatrix.trans.  The dK / dV
//   kernel computes the transposes, S^T = K Q^T and dP^T = V dO^T, so
//   that P^T and dS^T come out in accumulator fragments that are directly
//   the A operands of dV += P^T dO and dK += dS^T Q (dO and Q through
//   ldmatrix.trans): nothing but the streamed tiles passes through shared
//   memory.  Softmax, D and every accumulator stay fp32; P and dS are
//   rounded to bf16 only as MMA operands, as FlashAttention-2 and SDPA
//   do (the plain version's `operand_dtype` models it); scale is applied
//   to dK and dQ at the end.  Masks are evaluated only on tiles that
//   straddle the diagonal, a window edge or the end, and a warp skips a
//   tile with no key visible to its rows.  The grid runs the heaviest
//   blocks first (causal: the last q tiles, the first kv tiles).
// * `flash_bwd_dq` / `flash_bwd_dkdv`, fp32 (and bf16 at other strides)
//   on the CUDA cores, exact against the fp32 plain version: each tile is
//   staged in shared memory as fp32 with rows padded by one float, so
//   each of the products reads without bank conflicts whichever dimension
//   it walks; 256 threads as a 16 x 16 grid, thread (tx, ty) owning rows
//   ty + 16 r and columns tx + 16 s of a 64 x N product (a 4 x N/16
//   register tile) in fp32 FMAs.  Shared-memory reads bound it (one load
//   per two FMAs), at ~20 TFLOP/s.  At d 256 the tiles are 32 rows (a
//   2 x N/16 register tile), 133 / 137 KB of shared memory a block.
//
// Inputs are read with any (b, h, s) strides and a contiguous head dim,
// as the forward reads them; outputs are written with their own strides.
// head_dim 64, 128 and 256.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;            // 16 x 16

// query rows and keys a tile: 64, and 32 at d 256, where 64-row fp32
// tiles of Q, dO, K and V (~263 KB) would not fit shared memory
template <int D>
__host__ __device__ constexpr int cc_tile() {
  return D <= 128 ? 64 : 32;
}

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

// S = Q K^T and dP = dO V^T for one (q tile, kv tile) of 16 R rows and
// keys: thread (tx, ty) gets rows ty + 16 r, keys tx + 16 s
template <int D, int R>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tx, int ty, float (&s)[R][R],
                                       float (&dp)[R][R]) {
  constexpr int L = ld<D>();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float q[R], o[R], k[R], v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r] = Qs[(ty + 16 * r) * L + c];
      o[r] = dOs[(ty + 16 * r) * L + c];
      k[r] = Ks[(tx + 16 * r) * L + c];
      v[r] = Vs[(tx + 16 * r) * L + c];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[r][j] = fmaf(q[r], k[j], s[r][j]);
        dp[r][j] = fmaf(o[r], v[j], dp[r][j]);
      }
  }
}

// P and dS of one tile from its scores: P = exp(scale S - LSE) where the
// key is visible (0 elsewhere), dS = P (dP - D)
template <int R>
__device__ __forceinline__ void probs(float (&s)[R][R], float (&dp)[R][R],
                                      const float* lse_s, const float* d_s,
                                      int q0, int k0, int tx, int ty, int sq,
                                      int skv, int causal, int window,
                                      float scale) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = ty + 16 * r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
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
  constexpr int kBQ = cc_tile<D>(), kBK = kBQ, R = kBQ / 16;
  constexpr int kLdP = kBK + 1;          // padded row of a (q, k) tile
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

  float acc[R][DN];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[r][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                     // last tile consumed; D, LSE set
    stage<T, D>(Ks, kb, ks.s, k0, kBK, skv);
    stage<T, D>(Vs, vb, vs.s, k0, kBK, skv);
    __syncthreads();
    float s[R][R], dp[R][R];
    scores<D, R>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
    probs<R>(s, dp, lse_s, d_s, q0, k0, tx, ty, sq, skv, causal, window,
             scale);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < R; ++j)
        dSs[(ty + 16 * r) * kLdP + tx + 16 * j] = dp[r][j];
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float a[R], b[DN];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = dSs[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < DN; ++c) b[c] = Ks[j * L + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < DN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
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
  constexpr int kBQ = cc_tile<D>(), kBK = kBQ, R = kBQ / 16;
  constexpr int kLdP = kBQ + 1;          // padded row of a (q, k) tile
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

  float ak[R][DN], av[R][DN];            // dK, dV: keys ty + 16 r
#pragma unroll
  for (int r = 0; r < R; ++r)
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
      float s[R][R], dp[R][R];
      scores<D, R>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
      probs<R>(s, dp, lse_s, d_s, q0, k0, tx, ty, sq, skv, causal, window,
               scale);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          Ps[(ty + 16 * r) * kLdP + tx + 16 * j] = s[r][j];
          dSs[(ty + 16 * r) * kLdP + tx + 16 * j] = dp[r][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (the scale applied at the end)
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float p[R], ds[R], o[DN], qq[DN];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          p[r] = Ps[i * kLdP + ty + 16 * r];
          ds[r] = dSs[i * kLdP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          o[c] = dOs[i * L + tx + 16 * c];
          qq[c] = Qs[i * L + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
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
  for (int r = 0; r < R; ++r) {
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
constexpr int smem_dq() {                // Q, dO, K, V; dS; LSE, D
  constexpr int t = cc_tile<D>();
  return (int)sizeof(float) * (4 * t * ld<D>() + t * (t + 1) + 2 * t);
}

template <int D>
constexpr int smem_dkdv() {              // K, V, Q, dO; P, dS; LSE, D
  constexpr int t = cc_tile<D>();
  return (int)sizeof(float) * (4 * t * ld<D>() + 2 * t * (t + 1) + 2 * t);
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
  constexpr int kBQ = cc_tile<D>(), kBK = kBQ;
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
    case 256:
      return launch<T, 256>(a, stream);
    default:
      return repro::kUnsupported;
  }
}

// --- the tensor-core instance (bf16) ----------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {
// four warps; warp w owns rows 16 w .. +15 of the block's 64-row output
// tile: query rows (dQ kernel) or keys (dK / dV kernel)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 64;                  // dQ kernel: query rows a block
constexpr int kBK = 64;                  // dK / dV kernel: keys a block
constexpr float kLog2e = 1.4426950408889634f;

// the kv tile the dQ kernel streams: at d 256 its dQ accumulators take
// 128 registers a lane, which leaves room for 32-key S and dP only
template <int D>
__host__ __device__ constexpr int dq_k_tile() {
  return D <= 128 ? 64 : 32;
}

// the q tile the dK / dV kernel streams: at d 128 its 128 accumulator
// registers a lane (dK and dV) leave room for 32-row S^T and dP^T only
template <int D>
__host__ __device__ constexpr int dkdv_q_tile() {
  return D <= 64 ? 64 : 32;
}

// the dK / dV kernel's column halves: at d 256 a lane's dK and dV over
// all 256 columns would be 256 accumulator registers, so the block has
// two warpgroups, each recomputing S^T and dP^T of its 64 keys over the
// whole head dim and accumulating dK and dV for its half of the columns
template <int D>
__host__ __device__ constexpr int dkdv_halves() {
  return D <= 128 ? 1 : 2;
}

// blocks an SM must hold at once: at d 64 three (registers capped at 168
// a thread; measured faster than two blocks with fragments held in
// registers), at d 128 what the registers allow
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D <= 64 ? 3 : 1;
}

template <int D>
constexpr int smem_dq() {                // Q, dO, O; 2 stages of K and V
  return 2 * D * (3 * kBQ + 2 * 2 * dq_k_tile<D>());
}

template <int D>
constexpr int smem_dkdv() {              // K, V; 2 stages of Q, dO, LSE, D
  return 2 * D * 2 * kBK + 2 * dkdv_q_tile<D>() * (2 * 2 * D + 2 * 4);
}

// `rows` rows from r0 of one head's (s, d) bf16 slice into a swizzled
// tile by cp.async, 16 bytes a thread of the block's NT; rows past
// `limit` are zero-filled
template <int D, int rows, int NT = kThreads>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src,
                                          long long ss, int r0, int limit) {
  constexpr int DC = D / 8;
  static_assert(rows * DC % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < rows * DC / NT; ++j) {
    const int i = j * NT + threadIdx.x;
    const int r = i / DC, c = i % DC;
    const bool in = r0 + r < limit;
    const long long row = in ? r0 + r : 0;
    repro::cp_async_16(dst + repro::swz(r, c, DC), src + row * ss + c * 8,
                       in ? 16 : 0);
  }
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}
}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads, tc::min_blocks<D>())
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const float* __restrict__ lse, const bf16* __restrict__ dout,
                bf16* __restrict__ dq, float* __restrict__ delta, int g,
                int sq, int skv, Strides qs, Strides ks, Strides vs,
                Strides os, Strides dos, Strides dqs, int causal, int window,
                float scale) {
  using repro::swz_frag;
  constexpr int BQ = tc::kBQ, BK = tc::dq_k_tile<D>();
  constexpr int DC = D / 8;              // 16-byte chunks per row
  constexpr int KD = D / 16;             // k16 steps of S and dP
  constexpr int NS = BK / 8;             // n8 tiles of S and dP
  constexpr int KB = BK / 16;            // k16 steps of dS K
  constexpr int NO = D / 8;              // n8 tiles of dQ
  constexpr int kTile = BQ * D * 2;      // bytes of a 64-row tile
  constexpr int kKTile = BK * D * 2;     // bytes of a K or V tile
  static_assert(DC % 8 == 0, "tile shapes");
  extern __shared__ __align__(128) unsigned char smem_dq_tc[];
  unsigned char* Qs = smem_dq_tc;        // BQ x D each
  unsigned char* dOs = Qs + kTile;
  unsigned char* Os = dOs + kTile;
  unsigned char* KVs = Os + kTile;       // [stage][K, V] BK x D

  // z runs slowest: the last q tiles (causal: the most kv tiles) first
  const int ih = blockIdx.x, ib = blockIdx.y, hq = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr0 = q0 + warp * 16;        // the warp's first query row
  const bf16* qb = q + ib * qs.b + ih * qs.h;
  const bf16* kb = k + ib * ks.b + (ih / g) * ks.h;
  const bf16* vb = v + ib * vs.b + (ih / g) * vs.h;
  const bf16* ob = o + ib * os.b + ih * os.h;
  const bf16* dob = dout + ib * dos.b + ih * dos.h;
  bf16* dqb = dq + ib * dqs.b + ih * dqs.h;
  const long long row0 = ((long long)ib * hq + ih) * sq;   // lse / delta

  // the kv tiles these rows can see (the forward's range)
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;
  auto k_stage = [&](int stage) { return KVs + stage * 2 * kKTile; };
  auto v_stage = [&](int stage) { return k_stage(stage) + kKTile; };

  // two cp.async groups: Q, dO and O; then the first K and V tile
  tc::load_tile<D, BQ>(Qs, qb, qs.s, q0, sq);
  tc::load_tile<D, BQ>(dOs, dob, dos.s, q0, sq);
  tc::load_tile<D, BQ>(Os, ob, os.s, q0, sq);
  repro::cp_async_commit();
  if (t_begin < t_end) {
    tc::load_tile<D, BK>(k_stage(0), kb, ks.s, t_begin * BK, skv);
    tc::load_tile<D, BK>(v_stage(0), vb, vs.s, t_begin * BK, skv);
  }
  repro::cp_async_commit();

  // LSE of the lane's rows gr and gr + 8, in log2 units
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = wr0 + gr + 8 * h;
    lse2[h] = qp < sq ? lse[row0 + qp] * tc::kLog2e : 0.f;
  }
  repro::cp_async_wait<1>();             // Q, dO, O landed
  __syncthreads();
  const repro::FragLane fa = repro::frag_lane_a(lane);
  const repro::FragLane fb = repro::frag_lane_b(lane);
  // D = rowsum(dO o O) over the same fragments, reduced over the four
  // lanes of a row; rows past sq are zeros
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    uint32_t fo[4], fd[4];
    repro::ldmatrix_x4(fo, Os + swz_frag(fa, warp * 16, kd * 2, DC));
    repro::ldmatrix_x4(fd, dOs + swz_frag(fa, warp * 16, kd * 2, DC));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = tc::unpack_bf16x2(fo[i]), b = tc::unpack_bf16x2(fd[i]);
      dsum[i & 1] = fmaf(a.x, b.x, fmaf(a.y, b.y, dsum[i & 1]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
    dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
    const int qp = wr0 + gr + 8 * h;
    if (tq == 0 && qp < sq) delta[row0 + qp] = dsum[h];
  }

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    repro::cp_async_wait<0>();           // tile t landed
    __syncthreads();                     // ... for all; tile t - 1 is free
    if (t + 1 < t_end) {
      tc::load_tile<D, BK>(k_stage(stage ^ 1), kb, ks.s, (t + 1) * BK, skv);
      tc::load_tile<D, BK>(v_stage(stage ^ 1), vb, vs.s, (t + 1) * BK, skv);
    }
    repro::cp_async_commit();
    const int k0 = t * BK;
    // whether a key of the tile is visible to one of the warp's rows, and
    // whether every key is visible to every row (no mask to apply)
    const bool work = wr0 < sq && !(causal && k0 > wr0 + 15) &&
                      !(window > 0 && k0 + BK - 1 <= wr0 - window);
    if (!work) continue;
    const bool full = wr0 + 15 < sq && k0 + BK <= skv &&
                      (!causal || k0 + BK - 1 <= wr0) &&
                      (window <= 0 || k0 > wr0 + 15 - window);
    const unsigned char* kt = k_stage(stage);
    const unsigned char* vt = v_stage(stage);
    // S = Q K^T, dP = dO V^T
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t aq[4], ado[4];
      repro::ldmatrix_x4(aq, Qs + swz_frag(fa, warp * 16, kd * 2, DC));
      repro::ldmatrix_x4(ado, dOs + swz_frag(fa, warp * 16, kd * 2, DC));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        repro::ldmatrix_x4(b, kt + swz_frag(fb, np * 16, kd * 2, DC));
        repro::mma_bf16(s[2 * np], aq, b[0], b[1]);
        repro::mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        repro::ldmatrix_x4(b, vt + swz_frag(fb, np * 16, kd * 2, DC));
        repro::mma_bf16(dp[2 * np], ado, b[0], b[1]);
        repro::mma_bf16(dp[2 * np + 1], ado, b[2], b[3]);
      }
    }
    // P = exp(scale S - LSE) where visible, 0 elsewhere; dS = P (dP - D),
    // in place of S
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        float p = exp2f(fmaf(s[nt][i], scale * tc::kLog2e, -lse2[h]));
        if (!full) {
          const int qp = wr0 + gr + 8 * h;
          const int kp = k0 + nt * 8 + 2 * tq + (i & 1);
          p = visible(qp, kp, sq, skv, causal, window) ? p : 0.f;
        }
        s[nt][i] = p * (dp[nt][i] - dsum[h]);
      }
    // dQ += dS K: dS rounded to bf16 as the A operand, K through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t a[4];
      repro::acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t b[4];
        repro::ldmatrix_x4_trans(b, kt + swz_frag(fa, kk * 16, dp2 * 2, DC));
        repro::mma_bf16(acc[2 * dp2], a, b[0], b[1]);
        repro::mma_bf16(acc[2 * dp2 + 1], a, b[2], b[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = wr0 + gr + 8 * h;
    if (qp >= sq) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
      *reinterpret_cast<uint32_t*>(dqb + qp * dqs.s + nt * 8 + 2 * tq) =
          repro::pack_bf16x2(acc[nt][2 * h] * scale,
                             acc[nt][2 * h + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads * tc::dkdv_halves<D>(),
                                  tc::min_blocks<D>())
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const bf16* __restrict__ dout, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int g, int sq, int skv, Strides qs,
                  Strides ks, Strides vs, Strides dos, Strides dks,
                  Strides dvs, int causal, int window, float scale) {
  using repro::swz_frag;
  constexpr int BK = tc::kBK;
  constexpr int BQ = tc::dkdv_q_tile<D>();
  constexpr int NT = tc::kThreads * tc::dkdv_halves<D>();
  constexpr int DC = D / 8;
  constexpr int KD = D / 16;             // k16 steps of S^T and dP^T
  constexpr int NS = BQ / 8;             // n8 tiles of S^T and dP^T
  constexpr int KB = BQ / 16;            // k16 steps of P^T dO, dS^T Q
  constexpr int NO = D / 8 / tc::dkdv_halves<D>();   // n8 tiles of dK, dV
  constexpr int kKTile = BK * D * 2, kQTile = BQ * D * 2;
  constexpr int kStage = 2 * kQTile + 2 * BQ * 4;   // Q, dO, LSE, D
  static_assert(DC % 8 == 0 && 2 * BQ <= tc::kThreads, "tile shapes");
  extern __shared__ __align__(128) unsigned char smem_dkdv_tc[];
  unsigned char* Ks = smem_dkdv_tc;      // BK x D each
  unsigned char* Vs = Ks + kKTile;
  unsigned char* stages = Vs + kKTile;   // [stage][Q, dO, LSE, D]

  // z runs slowest: the first kv tiles (causal: the most q tiles) first
  const int hk = blockIdx.x, ib = blockIdx.y, hkv = gridDim.x;
  const int k0 = blockIdx.z * BK;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) % tc::kWarps;   // the warp's 16 keys
  // the warp's columns: pairs of 16-byte chunks cp0 .. cp0 + NO / 2 - 1
  const int cp0 = (tid >> 5) / tc::kWarps * NO / 2;
  const int gr = lane >> 2, tq = lane & 3;
  const int kw0 = k0 + warp * 16;        // the warp's first key
  const int hq = hkv * g;

  // the q tiles whose rows can see a key of this tile, for each head of
  // the group: iteration it is head hk g + it / nt, q tile t_begin + it % nt
  const int k_last = min(k0 + BK, skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_stop = window > 0 ? min(sq, k_last + window) : sq;
  const int t_begin = q_begin / BQ;
  const int t_end = q_begin < q_stop ? (q_stop + BQ - 1) / BQ : t_begin;
  const int nt = t_end - t_begin, n_it = g * nt;
  auto q_stage = [&](int stage) { return stages + stage * kStage; };
  auto do_stage = [&](int stage) { return q_stage(stage) + kQTile; };
  auto lse_stage = [&](int stage) {
    return reinterpret_cast<float*>(q_stage(stage) + 2 * kQTile);
  };
  auto d_stage = [&](int stage) { return lse_stage(stage) + BQ; };
  auto load_it = [&](int it, int stage) {
    const int ih = hk * g + it / nt;
    const int q0 = (t_begin + it % nt) * BQ;
    tc::load_tile<D, BQ, NT>(q_stage(stage), q + ib * qs.b + ih * qs.h,
                             qs.s, q0, sq);
    tc::load_tile<D, BQ, NT>(do_stage(stage), dout + ib * dos.b + ih * dos.h,
                             dos.s, q0, sq);
    // the rows' LSE and D, 4 bytes a thread; rows past sq zero-filled
    const long long row0 = ((long long)ib * hq + ih) * sq;
    const int r = tid % BQ;
    const bool in = q0 + r < sq;
    const long long idx = row0 + (in ? q0 + r : 0);
    if (tid < BQ)
      repro::cp_async_4(lse_stage(stage) + r, lse + idx, in ? 4 : 0);
    else if (tid < 2 * BQ)
      repro::cp_async_4(d_stage(stage) + r, delta + idx, in ? 4 : 0);
  };

  tc::load_tile<D, BK, NT>(Ks, k + ib * ks.b + hk * ks.h, ks.s, k0, skv);
  tc::load_tile<D, BK, NT>(Vs, v + ib * vs.b + hk * vs.h, vs.s, k0, skv);
  if (n_it > 0) load_it(0, 0);
  repro::cp_async_commit();

  const repro::FragLane fa = repro::frag_lane_a(lane);
  const repro::FragLane fb = repro::frag_lane_b(lane);
  const float scale_log2 = scale * tc::kLog2e;
  float ak[NO][4], av[NO][4];            // dK, dV: keys kw0 + gr (+ 8)
#pragma unroll
  for (int nt2 = 0; nt2 < NO; ++nt2)
#pragma unroll
    for (int i = 0; i < 4; ++i) ak[nt2][i] = av[nt2][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it & 1;
    repro::cp_async_wait<0>();           // iteration it (and K, V) landed
    __syncthreads();                     // ... for all; it - 1 is free
    if (it + 1 < n_it) load_it(it + 1, stage ^ 1);
    repro::cp_async_commit();
    const int q0 = (t_begin + it % nt) * BQ;
    const int q_last = min(q0 + BQ, sq) - 1;
    const bool work = kw0 < skv && !(causal && kw0 > q_last) &&
                      !(window > 0 && kw0 + 15 <= q0 - window);
    if (!work) continue;
    const bool full = q0 + BQ <= sq && kw0 + 16 <= skv &&
                      (!causal || kw0 + 15 <= q0) &&
                      (window <= 0 || kw0 > q0 + BQ - 1 - window);
    const unsigned char* qt = q_stage(stage);
    const unsigned char* dot = do_stage(stage);
    const float* lse_s = lse_stage(stage);
    const float* d_s = d_stage(stage);
    // S^T = K Q^T, dP^T = V dO^T: rows are the warp's keys, columns the
    // tile's query rows
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t akf[4], avf[4];
      repro::ldmatrix_x4(akf, Ks + swz_frag(fa, warp * 16, kd * 2, DC));
      repro::ldmatrix_x4(avf, Vs + swz_frag(fa, warp * 16, kd * 2, DC));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        repro::ldmatrix_x4(b, qt + swz_frag(fb, np * 16, kd * 2, DC));
        repro::mma_bf16(st[2 * np], akf, b[0], b[1]);
        repro::mma_bf16(st[2 * np + 1], akf, b[2], b[3]);
        repro::ldmatrix_x4(b, dot + swz_frag(fb, np * 16, kd * 2, DC));
        repro::mma_bf16(dpt[2 * np], avf, b[0], b[1]);
        repro::mma_bf16(dpt[2 * np + 1], avf, b[2], b[3]);
      }
    }
    // P^T where visible (0 elsewhere) in place of S^T, dS^T = P^T (dP^T -
    // D) in place of dP^T; the column's query row reads its LSE and D
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + n * 8 +
                                                          2 * tq);
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + n * 8 +
                                                         2 * tq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = i & 1;
        float p = exp2f(fmaf(st[n][i], scale_log2,
                             -(c ? l2.y : l2.x) * tc::kLog2e));
        if (!full) {
          const int qp = q0 + n * 8 + 2 * tq + c;
          const int kp = kw0 + gr + 8 * (i >> 1);
          p = visible(qp, kp, sq, skv, causal, window) ? p : 0.f;
        }
        st[n][i] = p;
        dpt[n][i] = p * (dpt[n][i] - (c ? d2.y : d2.x));
      }
    }
    // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16 as the A
    // operands, dO and Q through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t pa[4], da[4];
      repro::acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      repro::acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t b[4];
        const int cc = 2 * (cp0 + dp2);  // the pair's first chunk
        repro::ldmatrix_x4_trans(b, dot + swz_frag(fa, kk * 16, cc, DC));
        repro::mma_bf16(av[2 * dp2], pa, b[0], b[1]);
        repro::mma_bf16(av[2 * dp2 + 1], pa, b[2], b[3]);
        repro::ldmatrix_x4_trans(b, qt + swz_frag(fa, kk * 16, cc, DC));
        repro::mma_bf16(ak[2 * dp2], da, b[0], b[1]);
        repro::mma_bf16(ak[2 * dp2 + 1], da, b[2], b[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* dkb = dk + ib * dks.b + hk * dks.h;
  bf16* dvb = dv + ib * dvs.b + hk * dvs.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = kw0 + gr + 8 * h;
    if (kp >= skv) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = (2 * cp0 + n) * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(dkb + kp * dks.s + col) =
          repro::pack_bf16x2(ak[n][2 * h] * scale, ak[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + kp * dvs.s + col) =
          repro::pack_bf16x2(av[n][2 * h], av[n][2 * h + 1]);
    }
  }
}

template <int D>
int launch_tc(const Args& a, cudaStream_t stream) {
  constexpr int s1 = tc::smem_dq<D>(), s2 = tc::smem_dkdv<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return (int)err;
  const int g = a.hq / a.hkv;
  // dQ first: it writes the D the dK / dV kernel reads
  flash_bwd_dq_tc<D><<<dim3(a.hq, a.b, (a.sq + tc::kBQ - 1) / tc::kBQ),
                       tc::kThreads, s1, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o), a.lse,
      static_cast<const bf16*>(a.dout), static_cast<bf16*>(a.dq), a.delta, g,
      a.sq, a.skv, a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.causal, a.window,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_tc<D><<<dim3(a.hkv, a.b, (a.skv + tc::kBK - 1) / tc::kBK),
                         tc::kThreads * tc::dkdv_halves<D>(), s2, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lse, a.delta,
      static_cast<const bf16*>(a.dout), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), g, a.sq, a.skv, a.qs, a.ks, a.vs, a.dos,
      a.dks, a.dvs, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

// C entry point (ctypes).  q, o, dout, dq (b, hq, sq, d); k, v, dk, dv
// (b, hkv, skv, d): any (b, h, s) strides in elements, head dim
// contiguous.  lse and delta (b, hq, sq) contiguous fp32: lse from the
// forward, delta a workspace this call fills with D.  Returns 0, the
// cudaError_t of a refused launch, or -1 for a head_dim / dtype it does
// not take (head_dim 64, 128 and 256; fp32 and bf16).
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
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, delta, b, hq, hkv, sq, skv,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss},
               {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
               {dv_sb, dv_sh, dv_ss}, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_d<float>(d, a, st);
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16>(d, a, st);
  return repro::kUnsupported;
}

// The tensor-core instance: bf16, head_dim 64, 128 or 256, q, k, v, o, dout,
// dq, dk and dv 16-byte aligned with (b, h, s) strides in multiples of 8
// elements (rows are copied in 16-byte chunks and written in bf16 pairs).
// Same arguments and returns as above, less the dtype.
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int b, int hq, int hkv, int sq, int skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long dk_sb, long long dk_sh,
    long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, delta, b, hq, hkv, sq, skv,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss},
               {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
               {dv_sb, dv_sh, dv_ss}, causal, window, scale};
  if (!aligned16(a.q, a.qs) || !aligned16(a.k, a.ks) ||
      !aligned16(a.v, a.vs) || !aligned16(a.o, a.os) ||
      !aligned16(a.dout, a.dos) || !aligned16(a.dq, a.dqs) ||
      !aligned16(a.dk, a.dks) || !aligned16(a.dv, a.dvs))
    return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_tc<64>(a, st);
    case 128:
      return launch_tc<128>(a, st);
    case 256:
      return launch_tc<256>(a, st);
    default:
      return repro::kUnsupported;
  }
}
