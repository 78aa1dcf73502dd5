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
// visible pairs), 1.61e11 flops, 0.163 ms at 989 TFLOP/s.  Every instance
// keeps the same form: no atomics, so the result is the same bit for bit
// on every call.  A dQ kernel, one block per q tile (and query head),
// walks the kv tiles its rows can see (the forward's range: from the
// window's first tile to the causal diagonal), recomputing S, P, dP and
// dS per tile and accumulating dQ += dS K.  A dK / dV kernel, one block
// per kv tile (and kv head), walks the q tiles whose rows can see a key
// of the tile (from the causal diagonal to the window's last row) for
// the query heads of its kv head's group, accumulating dV += P^T dO and
// dK += dS^T Q.
//
// * `flash_bwd_dq_tc` / `flash_bwd_dkdv_tc`, bf16 at d 64 and 128
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
//   The other operand's tiles (K and V, resp. Q, dO and their rows' LSE
//   and D) stream into XOR-swizzled shared memory through a
//   double-buffered cp.async ring, rows past the end zero-filled by the
//   copy, so tile t + 1 loads while tile t is multiplied.  The dQ kernel
//   computes D for its rows first, then S = Q K^T and dP = dO V^T with K
//   and V through plain ldmatrix, P and dS on the accumulator fragments,
//   and dQ += dS K with dS packed to bf16 in registers as the A operand
//   and K through ldmatrix.trans.  The dK / dV kernel computes the
//   transposes, S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come
//   out in accumulator fragments that are directly the A operands of
//   dV += P^T dO and dK += dS^T Q (dO and Q through ldmatrix.trans):
//   nothing but the streamed tiles passes through shared memory.
//   Softmax, D and every accumulator stay fp32; P and dS are rounded to
//   bf16 only as MMA operands, as FlashAttention-2 and SDPA do (the plain
//   version's `operand_dtype` models it); scale is applied to dK and dQ
//   at the end.  Masks are evaluated only on tiles that straddle the
//   diagonal, a window edge or the end, and a warp skips a tile with no
//   key visible to its rows.  The grid runs the heaviest blocks first
//   (causal: the last q tiles, the first kv tiles).
// * `flash_bwd_dq_h256` / `flash_bwd_dkdv_h256`, bf16 at d 256
//   (recurrentgemma-2b's MQA: 10 query heads on one kv head), built for
//   Hopper's `wgmma` fed by TMA (`hopper.cuh`).  A dQ or dK / dV row of
//   256 fp32 values takes 128 accumulator registers a thread of a
//   warpgroup, so each output has a warpgroup of its own.  Four launches:
//   - `flash_bwd_delta_tc`: D = rowsum(dO o O), a warp a row, into the
//     workspace both kernels read (no kernel keeps O resident);
//   - the dQ kernel: a block of two warpgroups, each the 64 rows of one
//     query head of a pair of the group, so both read one K / V stream:
//     Q and dO of both heads stay resident (128 KB), 32-key K and V
//     tiles stream through a 3-stage `mbarrier` ring that one thread
//     fills by TMA (no producer warpgroup or warp: with 384 or 288
//     threads `__launch_bounds__` holds every thread to 168 registers,
//     which ptxas does not raise for the consumers' `setmaxnreg`, and
//     the accumulators spilled).  Per tile S = Q K^T and dP = dO V^T
//     (wgmma m64n32k16 from shared memory), P and dS on the
//     accumulators, then dQ += dS K with dS as the register operand
//     (m64n256k16, K read MN-major: no transposed copy);
//   - the dK / dV kernel: two warpgroups around a 64-key K and V tile
//     held resident, 64-row Q and dO tiles (with their rows' LSE and D,
//     1-D maps, each copy from the 16-byte boundary before the tile:
//     TMA starts no copy elsewhere) streaming through a 2-stage ring.
//     Each product is computed once: one warpgroup computes S^T = K Q^T,
//     P^T (handed to the other through shared memory in fp32, behind a
//     pair of `mbarrier`s) and dV += P^T dO; the other dP^T = V dO^T,
//     dS^T = P^T o (dP^T - D) and dK += dS^T Q (S^T and dP^T m64n64k16
//     from shared memory, the updates m64n256k16 with the register
//     operand, dO and Q MN-major).  At batch 1 with one kv head a kv
//     tile's work is its group's 10 heads, and 64 tiles would fill half
//     the card: the group's heads are split over `splits` blocks
//     (`bwd_splits` in the wrapper: from the shape alone, never from the
//     card), each writing fp32 partial dK and dV into a workspace;
//   - `flash_bwd_sum`: the splits' partials summed in split order, dK
//     scaled, rounded once to the output's dtype and strides.
//   TMA zero-fills rows past the end; a wgmma never sits on a branch of
//   its own (the roles pick their operands' addresses, not their code).
// * `flash_bwd_dq` / `flash_bwd_dkdv`, fp32 (and bf16 at other strides)
//   on the CUDA cores, exact against the fp32 plain version: each tile is
//   staged in shared memory as fp32 with rows padded by one float, so
//   each of the products reads without bank conflicts whichever dimension
//   it walks; 256 threads as a 16 x 16 grid, thread (tx, ty) owning rows
//   ty + 16 r and columns tx + 16 s of a 64 x N product (a 4 x N/16
//   register tile) in fp32 FMAs.  Shared-memory reads bound it (one load
//   per two FMAs), at ~20 TFLOP/s.  At d 256 the tiles are 32 rows, and
//   the register tiles change shape, since a 2 x 2 or 2 x 16 one would
//   read one value from shared memory per FMA or ~0.6: S and dP are
//   summed by four 64-thread groups, each over a quarter of d with a 4 x
//   4 tile (`scores256`), and dQ, dK and dV take 4 x 8 tiles read as
//   float4s (`Acc`); one block fills an SM, so in fp32 the streamed
//   tiles come through a cp.async double buffer (~225 KB a block); and
//   the dK / dV kernel splits the group as the bf16 one does, into the
//   same workspace and sum.
//
// Inputs are read with any (b, h, s) strides and a contiguous head dim,
// as the forward reads them; outputs are written with their own strides.
// head_dim 64, 128 and 256.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
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

// the padded row of a (row, d) tile: one float past d, so that a column
// walk hits every bank once; at d 256 four, so that rows stay 16-byte
// aligned for the scores' float4 reads along d (8 rows a quarter-warp
// then still fall on distinct banks)
template <int D>
__host__ __device__ constexpr int ld() {
  return D == 256 ? D + 4 : D + 1;
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

// A thread's accumulators of a (row, d) product (dQ, dK, dV): kR rows x
// kC columns.  Below d 256 the 16 x 16 grid's: rows ty + 16 i, columns
// tx + 16 c.  At d 256, where the 2 x 16 tile would read 18 values a row
// for 32 FMAs, 4 x 8: warp w takes rows w + 8 i and lane l the columns
// 4 l + 128 (c / 4) + c % 4, so a row of the streamed tile is read as
// two float4s a lane (a warp reads 512 contiguous bytes) and the other
// operand is one broadcast value a row.
template <int D>
struct Acc {
  static constexpr int kR = D == 256 ? 4 : cc_tile<D>() / 16;
  static constexpr int kC = D == 256 ? 8 : D / 16;
  __device__ static int row(int i) {
    return D == 256 ? threadIdx.x / 32 + 8 * i : (threadIdx.x >> 4) + 16 * i;
  }
  __device__ static int col(int c) {
    return D == 256 ? 4 * (threadIdx.x % 32) + 128 * (c / 4) + c % 4
                    : (threadIdx.x & 15) + 16 * c;
  }
  // the thread's columns of one row of a padded tile
  __device__ static void read(float (&x)[kC], const float* row_p) {
    if constexpr (D == 256) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            row_p + 128 * h + 4 * (threadIdx.x % 32));
        x[4 * h] = v.x, x[4 * h + 1] = v.y, x[4 * h + 2] = v.z,
        x[4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) x[c] = row_p[col(c)];
    }
  }
};

// Whether the streamed tiles come through a cp.async double buffer (the
// next tile loads while this one is multiplied): fp32 at d 256, where
// one block fills an SM and would otherwise wait out every tile's loads.
// Elsewhere each tile is staged in place (bf16 is widened on the way).
template <typename T, int D>
__host__ __device__ constexpr bool pipelined() {
  return sizeof(T) == 4 && D == 256;
}

// `stage` by 4-byte cp.async (fp32 only): rows past `limit` zero-filled
template <int D>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            long long ss, int r0, int rows,
                                            int limit) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = r0 + r < limit;
    repro::cp_async_4(dst + r * ld<D>() + c,
                      src + (long long)(in ? r0 + r : 0) * ss + c,
                      in ? 4 : 0);
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

// S = Q K^T and dP = dO V^T of a 32 x 32 tile at d 256.  The 16 x 16
// grid's 2 x 2 register tile reads one value from shared memory per FMA;
// here each of four 64-thread groups sums one quarter of d with a 4 x 4
// tile (half a value per FMA, four steps of d a read), and the quarters
// are added through `red` (2 slots of S and dP, rows of 40 floats: a
// warp's stores fall on distinct banks) as (0 + 2) + (1 + 3).  Thread u
// of group 0 ends with the sums at row u / 8 + 8 i, key u % 8 + 8 j.
constexpr int kRedLd = 40;
constexpr int kRedFloats = 2 * 2 * 32 * kRedLd;

__device__ __forceinline__ void scores256(const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          float* red, float (&s)[4][4],
                                          float (&dp)[4][4]) {
  constexpr int L = ld<256>(), P = 32 * kRedLd;
  const int gq = threadIdx.x / 64, u = threadIdx.x % 64;
  const int ur = u / 8, uc = u % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int c = 64 * gq; c < 64 * gq + 64; c += 4) {
    float4 q[4], o[4], k[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = *reinterpret_cast<const float4*>(Qs + (ur + 8 * i) * L + c);
      o[i] = *reinterpret_cast<const float4*>(dOs + (ur + 8 * i) * L + c);
      k[i] = *reinterpret_cast<const float4*>(Ks + (uc + 8 * i) * L + c);
      v[i] = *reinterpret_cast<const float4*>(Vs + (uc + 8 * i) * L + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
        s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
        s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
        s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
        dp[i][j] = fmaf(o[i].x, v[j].x, dp[i][j]);
        dp[i][j] = fmaf(o[i].y, v[j].y, dp[i][j]);
        dp[i][j] = fmaf(o[i].z, v[j].z, dp[i][j]);
        dp[i][j] = fmaf(o[i].w, v[j].w, dp[i][j]);
      }
  }
  auto put = [&](int slot) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[2 * slot * P + (ur + 8 * i) * kRedLd + uc + 8 * j] = s[i][j];
        red[(2 * slot + 1) * P + (ur + 8 * i) * kRedLd + uc + 8 * j] =
            dp[i][j];
      }
  };
  auto add = [&](int slot) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += red[2 * slot * P + (ur + 8 * i) * kRedLd + uc + 8 * j];
        dp[i][j] +=
            red[(2 * slot + 1) * P + (ur + 8 * i) * kRedLd + uc + 8 * j];
      }
  };
  // `red` was last read before the caller's previous barrier
  if (gq >= 2) put(gq - 2);
  __syncthreads();
  if (gq < 2) add(gq);
  __syncthreads();
  if (gq == 1) put(0);
  __syncthreads();
  if (gq == 0) add(0);
}

// P and dS of one (q tile, kv tile) into shared memory, (query row, key)
// with rows of `ldp`: dS at `ds_out`, P at `p_out` unless it is null.
// Every thread of the block calls it.
template <int D, int R>
__device__ __forceinline__ void tile_probs(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    float* red, const float* lse_s, const float* d_s, float* p_out,
    float* ds_out, int ldp, int q0, int k0, int sq, int skv, int causal,
    int window, float scale) {
  if constexpr (D == 256) {
    float s[4][4], dp[4][4];
    scores256(Qs, dOs, Ks, Vs, red, s, dp);
    if (threadIdx.x < 64) {
      const int ur = threadIdx.x / 8, uc = threadIdx.x % 8;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ur + 8 * i, key = uc + 8 * j;
          const bool ok =
              visible(q0 + row, k0 + key, sq, skv, causal, window);
          const float pr = ok ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
          if (p_out) p_out[row * ldp + key] = pr;
          ds_out[row * ldp + key] = pr * (dp[i][j] - d_s[row]);
        }
    }
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float s[R][R], dp[R][R];
    scores<D, R>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
    probs<R>(s, dp, lse_s, d_s, q0, k0, tx, ty, sq, skv, causal, window,
             scale);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (p_out) p_out[(ty + 16 * r) * ldp + tx + 16 * j] = s[r][j];
        ds_out[(ty + 16 * r) * ldp + tx + 16 * j] = dp[r][j];
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
  constexpr int kBQ = cc_tile<D>(), kBK = kBQ, R = kBQ / 16;
  constexpr int kLdP = kBK + 1;          // padded row of a (q, k) tile
  constexpr bool kPipe = pipelined<T, D>();
  extern __shared__ float smem[];
  float* Qs = smem;                      // kBQ x L
  float* dOs = Qs + kBQ * L;             // kBQ x L
  float* KV = dOs + kBQ * L;             // [buffer][K, V] kBK x L
  float* dSs = KV + (kPipe ? 4 : 2) * kBK * L;   // kBQ x kLdP
  float* lse_s = dSs + kBQ * kLdP;       // kBQ
  float* d_s = lse_s + kBQ;              // kBQ
  float* red = d_s + kBQ;                // d 256: scores256's partials

  const int ih = blockIdx.y, ib = blockIdx.z, hq = gridDim.y;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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

  using A = Acc<D>;
  float acc[A::kR][A::kC];               // dQ: rows A::row, columns A::col
#pragma unroll
  for (int r = 0; r < A::kR; ++r)
#pragma unroll
    for (int c = 0; c < A::kC; ++c) acc[r][c] = 0.f;

  auto load_kv = [&](int t, float* Kd) {
    if constexpr (kPipe) {
      stage_async<D>(Kd, kb, ks.s, t * kBK, kBK, skv);
      stage_async<D>(Kd + kBK * L, vb, vs.s, t * kBK, kBK, skv);
    } else {
      stage<T, D>(Kd, kb, ks.s, t * kBK, kBK, skv);
      stage<T, D>(Kd + kBK * L, vb, vs.s, t * kBK, kBK, skv);
    }
  };
  if constexpr (kPipe) {
    if (t_begin < t_end) load_kv(t_begin, KV);
    repro::cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    float* Ks = KV + (kPipe ? (t - t_begin) & 1 : 0) * 2 * kBK * L;
    float* Vs = Ks + kBK * L;
    __syncthreads();                     // last tile consumed; D, LSE set
    if constexpr (kPipe) {
      if (t + 1 < t_end)                 // into the buffer of tile t - 1
        load_kv(t + 1, KV + ((t + 1 - t_begin) & 1) * 2 * kBK * L);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();         // tile t landed
    } else {
      load_kv(t, Ks);
    }
    __syncthreads();
    tile_probs<D, R>(Qs, dOs, Ks, Vs, red, lse_s, d_s, nullptr, dSs, kLdP,
                     q0, k0, sq, skv, causal, window, scale);
    __syncthreads();
    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float a[A::kR], b[A::kC];
#pragma unroll
      for (int r = 0; r < A::kR; ++r) a[r] = dSs[A::row(r) * kLdP + j];
      A::read(b, Ks + j * L);
#pragma unroll
      for (int r = 0; r < A::kR; ++r)
#pragma unroll
        for (int c = 0; c < A::kC; ++c)
          acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < A::kR; ++r) {
    const int qp = q0 + A::row(r);
    if (qp < sq)
#pragma unroll
      for (int c = 0; c < A::kC; ++c)
        dqb[(long long)qp * dqs.s + A::col(c)] =
            repro::from_f32<T>(acc[r][c] * scale);
  }
}

// The query heads [first, end) of kv head hk's group that split `split`
// of `splits` takes: every head of the group exactly once over the splits
// (the wrapper's `split_heads` gives the same ranges).
__host__ __device__ __forceinline__ int split_head(int hk, int g, int split,
                                                   int splits) {
  return hk * g + split * g / splits;
}

// The fp32 partial dK and dV of one split: (2, splits, b, hkv, skv, D),
// dK first, each unscaled.
__device__ __forceinline__ float* split_part(float* ws, int dv, int split,
                                             int splits, int ib, int b,
                                             int hk, int hkv, int skv,
                                             int D) {
  return ws + ((((long long)dv * splits + split) * b + ib) * hkv + hk) *
                  (long long)skv * D;
}

// At d 256 the dK / dV kernel takes the heads of one split of its group
// and writes fp32 partials (unscaled dK) into `ws` for flash_bwd_sum;
// below, splits is 1 and it writes dk and dv itself.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const T* __restrict__ dout,
               T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ ws,
               int splits, int g, int sq, int skv, Strides qs, Strides ks,
               Strides vs, Strides dos, Strides dks, Strides dvs, int causal,
               int window, float scale) {
  constexpr int L = ld<D>();
  constexpr int kBQ = cc_tile<D>(), kBK = kBQ, R = kBQ / 16;
  constexpr int kLdP = kBQ + 1;          // padded row of a (q, k) tile
  constexpr bool kPipe = pipelined<T, D>();
  extern __shared__ float smem[];
  float* Ks = smem;                      // kBK x L
  float* Vs = Ks + kBK * L;              // kBK x L
  float* QD = Vs + kBK * L;              // [buffer][Q, dO] kBQ x L
  float* Ps = QD + (kPipe ? 4 : 2) * kBQ * L;   // kBQ x kLdP
  float* dSs = Ps + kBQ * kLdP;          // kBQ x kLdP
  float* LD = dSs + kBQ * kLdP;          // [buffer][LSE, D] kBQ
  float* red = LD + (kPipe ? 4 : 2) * kBQ;   // d 256: scores256's partials

  // z runs slowest: the first kv tiles (causal: the most q tiles) first
  const int hk = blockIdx.x / splits, split = blockIdx.x % splits;
  const int ib = blockIdx.y, hkv = gridDim.x / splits;
  const int k0 = blockIdx.z * kBK;
  const int tid = threadIdx.x;
  const int hq = hkv * g;

  stage<T, D>(Ks, k + ib * ks.b + hk * ks.h, ks.s, k0, kBK, skv);
  stage<T, D>(Vs, v + ib * vs.b + hk * vs.h, vs.s, k0, kBK, skv);

  // the q tiles whose rows can see a key of this tile
  const int k_last = min(k0 + kBK, skv) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_stop = window > 0 ? min(sq, k_last + window) : sq;
  const int t_begin = q_begin / kBQ;
  const int t_end = q_begin < q_stop ? (q_stop + kBQ - 1) / kBQ : t_begin;

  using A = Acc<D>;
  float ak[A::kR][A::kC], av[A::kR][A::kC];   // dK, dV: keys A::row
#pragma unroll
  for (int r = 0; r < A::kR; ++r)
#pragma unroll
    for (int c = 0; c < A::kC; ++c) ak[r][c] = av[r][c] = 0.f;

  // iteration it: head h_first + it / nt of the split, q tile
  // t_begin + it % nt
  const int h_first = split_head(hk, g, split, splits);
  const int nt = t_end - t_begin;
  const int n_it = (split_head(hk, g, split + 1, splits) - h_first) * nt;
  auto load_it = [&](int it, int buf) {
    const int ih = h_first + it / nt, q0 = (t_begin + it % nt) * kBQ;
    const T* qb = q + ib * qs.b + ih * qs.h;
    const T* dob = dout + ib * dos.b + ih * dos.h;
    const long long row0 = ((long long)ib * hq + ih) * sq;
    float* Qd = QD + buf * 2 * kBQ * L;
    float* ld_s = LD + buf * 2 * kBQ;
    if constexpr (kPipe) {
      stage_async<D>(Qd, qb, qs.s, q0, kBQ, sq);
      stage_async<D>(Qd + kBQ * L, dob, dos.s, q0, kBQ, sq);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = q0 + r < sq;
        const long long i = row0 + (in ? q0 + r : 0);
        repro::cp_async_4(ld_s + r, lse + i, in ? 4 : 0);
        repro::cp_async_4(ld_s + kBQ + r, delta + i, in ? 4 : 0);
      }
    } else {
      stage<T, D>(Qd, qb, qs.s, q0, kBQ, sq);
      stage<T, D>(Qd + kBQ * L, dob, dos.s, q0, kBQ, sq);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool in = q0 + r < sq;
        ld_s[r] = in ? lse[row0 + q0 + r] : 0.f;
        ld_s[kBQ + r] = in ? delta[row0 + q0 + r] : 0.f;
      }
    }
  };
  if constexpr (kPipe) {
    if (n_it > 0) load_it(0, 0);
    repro::cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (t_begin + it % nt) * kBQ;
    const int buf = kPipe ? it & 1 : 0;
    float* Qs = QD + buf * 2 * kBQ * L;
    float* dOs = Qs + kBQ * L;
    float* lse_s = LD + buf * 2 * kBQ;
    float* d_s = lse_s + kBQ;
    __syncthreads();                   // last tile consumed
    if constexpr (kPipe) {
      if (it + 1 < n_it) load_it(it + 1, buf ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();       // iteration it landed
    } else {
      load_it(it, 0);
    }
    __syncthreads();
    tile_probs<D, R>(Qs, dOs, Ks, Vs, red, lse_s, d_s, Ps, dSs, kLdP, q0,
                     k0, sq, skv, causal, window, scale);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q (the scale applied at the end)
#pragma unroll 4
    for (int i = 0; i < kBQ; ++i) {
      float p[A::kR], ds[A::kR], o[A::kC], qq[A::kC];
#pragma unroll
      for (int r = 0; r < A::kR; ++r) {
        p[r] = Ps[i * kLdP + A::row(r)];
        ds[r] = dSs[i * kLdP + A::row(r)];
      }
      A::read(o, dOs + i * L);
      A::read(qq, Qs + i * L);
#pragma unroll
      for (int r = 0; r < A::kR; ++r)
#pragma unroll
        for (int c = 0; c < A::kC; ++c) {
          av[r][c] = fmaf(p[r], o[c], av[r][c]);
          ak[r][c] = fmaf(ds[r], qq[c], ak[r][c]);
        }
    }
  }

  if constexpr (D == 256) {
    const int b = gridDim.y;
    float* pk = split_part(ws, 0, split, splits, ib, b, hk, hkv, skv, D);
    float* pv = split_part(ws, 1, split, splits, ib, b, hk, hkv, skv, D);
#pragma unroll
    for (int r = 0; r < A::kR; ++r) {
      const int kp = k0 + A::row(r);
      if (kp < skv)
#pragma unroll
        for (int c = 0; c < A::kC; ++c) {
          pk[(long long)kp * D + A::col(c)] = ak[r][c];
          pv[(long long)kp * D + A::col(c)] = av[r][c];
        }
    }
  } else {
    T* dkb = dk + ib * dks.b + hk * dks.h;
    T* dvb = dv + ib * dvs.b + hk * dvs.h;
#pragma unroll
    for (int r = 0; r < A::kR; ++r) {
      const int kp = k0 + A::row(r);
      if (kp < skv)
#pragma unroll
        for (int c = 0; c < A::kC; ++c) {
          dkb[(long long)kp * dks.s + A::col(c)] =
              repro::from_f32<T>(ak[r][c] * scale);
          dvb[(long long)kp * dvs.s + A::col(c)] =
              repro::from_f32<T>(av[r][c]);
        }
    }
  }
}

// dK = scale x the sum of the splits' partial dK in split order, dV the
// same unscaled, each rounded once to T at the output's strides; four
// consecutive values of d a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum(const float* __restrict__ ws, T* __restrict__ dk,
              T* __restrict__ dv, int splits, int hkv, int skv, int d,
              Strides dks, Strides dvs, float scale, long long n4) {
  const long long part = 4 * n4;         // values of one split's dK
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const int c = e % d;
    const long long row = e / d;
    const int kp = row % skv;
    const int hk = (row / skv) % hkv;
    const long long ib = row / skv / hkv;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int s = 0; s < splits; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(ws + s * part + e);
      const float4 b =
          *reinterpret_cast<const float4*>(ws + (splits + s) * part + e);
      sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
      sv.x += b.x, sv.y += b.y, sv.z += b.z, sv.w += b.w;
    }
    T* ok = dk + ib * dks.b + hk * dks.h + kp * dks.s + c;
    T* ov = dv + ib * dvs.b + hk * dvs.h + kp * dvs.s + c;
    ok[0] = repro::from_f32<T>(sk.x * scale);
    ok[1] = repro::from_f32<T>(sk.y * scale);
    ok[2] = repro::from_f32<T>(sk.z * scale);
    ok[3] = repro::from_f32<T>(sk.w * scale);
    ov[0] = repro::from_f32<T>(sv.x);
    ov[1] = repro::from_f32<T>(sv.y);
    ov[2] = repro::from_f32<T>(sv.z);
    ov[3] = repro::from_f32<T>(sv.w);
  }
}

template <typename T, int D>
constexpr int smem_dq() {      // Q, dO, K, V (x2); dS; LSE, D; partials
  constexpr int t = cc_tile<D>(), kv = pipelined<T, D>() ? 4 : 2;
  return (int)sizeof(float) *
         ((2 + kv) * t * ld<D>() + t * (t + 1) + 2 * t +
          (D == 256 ? kRedFloats : 0));
}

template <typename T, int D>
constexpr int smem_dkdv() {    // K, V, Q, dO (x2); P, dS; LSE, D; partials
  constexpr int t = cc_tile<D>(), n = pipelined<T, D>() ? 2 : 1;
  return (int)sizeof(float) *
         ((2 + 2 * n) * t * ld<D>() + 2 * t * (t + 1) + 2 * n * t +
          (D == 256 ? kRedFloats : 0));
}
static_assert(smem_dq<float, 256>() <= 232448 &&
                  smem_dkdv<float, 256>() <= 232448,
              "a block's shared memory on the H100");

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  float* ws;                             // d 256: the splits' partials
  int splits;                            // d 256: blocks a kv tile's group
  int b, hq, hkv, sq, skv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int causal, window;
  float scale;
};

template <typename T>
int launch_sum(const Args& a, cudaStream_t stream) {
  const long long n4 = (long long)a.b * a.hkv * a.skv * 256 / 4;
  const long long blocks = std::min<long long>((n4 + 255) / 256, 4096);
  flash_bwd_sum<T><<<(int)blocks, 256, 0, stream>>>(
      a.ws, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.splits, a.hkv,
      a.skv, 256, a.dks, a.dvs, a.scale, n4);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int s1 = smem_dq<T, D>(), s2 = smem_dkdv<T, D>();
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
  const int splits = D == 256 ? a.splits : 1;
  flash_bwd_dkdv<T, D><<<dim3(a.hkv * splits, a.b, (a.skv + kBK - 1) / kBK),
                         kThreads, s2, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.lse, a.delta,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.ws, splits, g, a.sq, a.skv, a.qs, a.ks, a.vs,
      a.dos, a.dks, a.dvs, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || D != 256) return (int)err;
  return launch_sum<T>(a, stream);
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

// the q tile the dK / dV kernel streams: at d 128 its 128 accumulator
// registers a lane (dK and dV) leave room for 32-row S^T and dP^T only
template <int D>
__host__ __device__ constexpr int dkdv_q_tile() {
  return D <= 64 ? 64 : 32;
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
  return 2 * D * (3 * kBQ + 2 * 2 * kBK);
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
  constexpr int BQ = tc::kBQ, BK = tc::kBK;
  constexpr int DC = D / 8;              // 16-byte chunks per row
  constexpr int KD = D / 16;             // k16 steps of S and dP
  constexpr int NS = BK / 8;             // n8 tiles of S and dP
  constexpr int KB = BK / 16;            // k16 steps of dS K
  constexpr int NO = D / 8;              // n8 tiles of dQ
  constexpr int kTile = BQ * D * 2;      // bytes of a 64-row tile
  constexpr int kKTile = BK * D * 2;     // bytes of a K or V tile
  static_assert(DC % 8 == 0 && D <= 128, "tile shapes");
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
__global__ void __launch_bounds__(tc::kThreads, tc::min_blocks<D>())
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
  constexpr int NT = tc::kThreads;
  constexpr int DC = D / 8;
  constexpr int KD = D / 16;             // k16 steps of S^T and dP^T
  constexpr int NS = BQ / 8;             // n8 tiles of S^T and dP^T
  constexpr int KB = BQ / 16;            // k16 steps of P^T dO, dS^T Q
  constexpr int NO = D / 8;              // n8 tiles of dK, dV
  constexpr int kKTile = BK * D * 2, kQTile = BQ * D * 2;
  constexpr int kStage = 2 * kQTile + 2 * BQ * 4;   // Q, dO, LSE, D
  static_assert(DC % 8 == 0 && 2 * BQ <= tc::kThreads && D <= 128,
                "tile shapes");
  extern __shared__ __align__(128) unsigned char smem_dkdv_tc[];
  unsigned char* Ks = smem_dkdv_tc;      // BK x D each
  unsigned char* Vs = Ks + kKTile;
  unsigned char* stages = Vs + kKTile;   // [stage][Q, dO, LSE, D]

  // z runs slowest: the first kv tiles (causal: the most q tiles) first
  const int hk = blockIdx.x, ib = blockIdx.y, hkv = gridDim.x;
  const int k0 = blockIdx.z * BK;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;             // the warp's 16 keys
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
        const int cc = 2 * dp2;          // the pair's first chunk
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
      const int col = n * 8 + 2 * tq;
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
                         tc::kThreads, s2, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.lse, a.delta,
      static_cast<const bf16*>(a.dout), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), g, a.sq, a.skv, a.qs, a.ks, a.vs, a.dos,
      a.dks, a.dvs, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// --- the tensor-core instance at head_dim 256 (wgmma + TMA) -----------------

namespace h256 {
constexpr int kD = 256;
constexpr int kLine = 128;               // bytes of one swizzled line
constexpr int kRows = 64;                // rows of a Q, dO, K or V tile
constexpr int kBox = kRows * kLine;      // one 64-value box of such a tile
constexpr int kTile = kD / 64 * kBox;    // 32 KB: 64 rows x 256 bf16
constexpr int kBKq = 32;                 // keys of the dQ kernel's tiles
constexpr int kKVBox = kBKq * kLine;
constexpr int kKVTile = kD / 64 * kKVBox;   // 16 KB
constexpr int kDqStages = 3;             // the dQ kernel's K / V ring
constexpr int kStages = 2;               // the dK / dV kernel's Q / dO ring
constexpr int kThreads = 256;            // two warpgroups
// Q and dO of two heads; the K / V ring; its barriers and Q / dO's
constexpr int kSmemDq =
    4 * kTile + kDqStages * 2 * kKVTile + 8 * (2 * kDqStages + 1) + 1024;
// The LSE and D of a q tile's rows come by TMA from the 16-byte boundary
// at or before the tile's first row (a copy must start on one): a box of
// 68 values, in a slot of 96.
constexpr int kLdBox = kRows + 4;
constexpr int kLdSlot = 96;
// K and V; the Q / dO ring; P^T twice (fp32, 64 x 64); LSE and D of each
// stage; the barriers (K / V's, the ring's, P^T's)
constexpr int kPBytes = kRows * kRows * 4;
constexpr int kSmemDkdv = 2 * kTile + kStages * 2 * kTile + 2 * kPBytes +
                          kStages * 2 * kLdSlot * 4 + 8 * (1 + 4 * kStages) +
                          1024;
static_assert(kSmemDq <= 232448 && kSmemDkdv <= 232448,
              "a block's shared memory on the H100");

// A descriptor the compiler must recompute in the loop that uses it: the
// steps derived from a loop-invariant one would otherwise be hoisted and
// held in registers the accumulators need.
__device__ __forceinline__ uint64_t fresh(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}
// Steps of a descriptor (hopper.cuh's layouts) over a tile of 64-value
// boxes `box` bytes apart: K-major, step kk of 16 along d; MN-major, step
// kk of 16 rows.  The start address is the low field, in 16-byte units.
__device__ __forceinline__ uint64_t k_step(uint64_t d, int box, int kk) {
  return d + ((kk / 4 * box + kk % 4 * 32) >> 4);
}
__device__ __forceinline__ uint64_t mn_step(uint64_t d, int kk) {
  return d + ((kk * 16 * kLine) >> 4);
}
__device__ __forceinline__ uint64_t k_desc(const unsigned char* tile) {
  return fresh(repro::sm90::desc_sw128(tile, 16, 1024));
}
__device__ __forceinline__ uint64_t mn_desc(const unsigned char* tile,
                                            int box) {
  return fresh(repro::sm90::desc_sw128(tile, box, 1024));
}

// The register operand of k16 step kk from an m64nN accumulator whose
// columns are the reduction: bf16 pairs, as the plain version's
// `operand_dtype` rounds them.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4],
                                         const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = repro::pack_bf16x2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

struct Params {
  const float* lse;
  const float* delta;
  bf16* dq;
  float* ws;
  int b, hq, hkv, g, sq, skv, splits;
  Strides dqs;
  int causal, window;
  float scale;
};
}  // namespace h256

// D = rowsum(dO o O) of every row, one warp a row, 16 bytes a lane.
__global__ void __launch_bounds__(256)
flash_bwd_delta_tc(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, int hq, int sq, int d,
                   Strides os, Strides dos, long long rows) {
  const long long row = blockIdx.x * 8ll + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int qp = row % sq, ih = row / sq % hq;
  const long long ib = row / sq / hq;
  const bf16* orow = o + ib * os.b + ih * os.h + qp * os.s;
  const bf16* drow = dout + ib * dos.b + ih * dos.h + qp * dos.s;
  float acc = 0.f;
  for (int c = lane; c < d / 8; c += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(orow + 8 * c);
    const uint4 y = *reinterpret_cast<const uint4*>(drow + 8 * c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = tc::unpack_bf16x2(xs[i]), b = tc::unpack_bf16x2(ys[i]);
      acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
    }
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// dQ at d 256.  Block (pair of the group's heads x kv head, batch row, q
// tile from the last): warpgroup c takes the 64 rows of head 2 pair + c
// of the group; past the group's end (an odd group) it repeats head
// 2 pair and writes nothing, so both run the same code.  Thread 0 issues
// the TMA copies: Q and dO, then the first K / V tiles; warp 0 refills
// each ring slot once both warpgroups have released it.  Maps: q_m,
// do_m with 64-row boxes; k_m, v_m with 32-row boxes.
__global__ void __launch_bounds__(h256::kThreads, 1)
flash_bwd_dq_h256(const __grid_constant__ CUtensorMap q_m,
                  const __grid_constant__ CUtensorMap do_m,
                  const __grid_constant__ CUtensorMap k_m,
                  const __grid_constant__ CUtensorMap v_m, h256::Params p) {
  using namespace repro::sm90;
  using h256::kTile;
  using h256::kKVTile;
  constexpr int S = h256::kDqStages, BK = h256::kBKq;
  extern __shared__ unsigned char smem_h256[];
  unsigned char* base = smem_h256 + ((1024 - (smem_addr(smem_h256) & 1023)) &
                                     1023);
  unsigned char* Qs = base;              // [head of the pair] 64 x 256
  unsigned char* dOs = Qs + 2 * kTile;
  unsigned char* ring = dOs + 2 * kTile; // [stage][K, V] 32 x 256
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * 2 * kKVTile);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int npairs = (p.g + 1) / 2;
  const int pair = blockIdx.x % npairs, hk = blockIdx.x / npairs;
  const int ib = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;
  const int heads = min(2, p.g - 2 * pair);     // 1 or 2
  // the kv tiles these rows can see (the forward's range)
  const int q_last = min(q0 + 64, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, q_last + 1) : p.skv;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int n = max(0, (k_end + BK - 1) / BK - t_begin);
  auto issue = [&](int i) {              // tile t_begin + i into its slot
    const int s = i % S;
    unsigned char* kt = ring + s * 2 * kKVTile;
    mbar_arrive_expect_tx(&full[s], 2 * kKVTile);
    for (int x = 0; x < 4; ++x) {
      tma_load_4d(kt + x * h256::kKVBox, &k_m, &full[s], 64 * x,
                  (t_begin + i) * BK, hk, ib);
      tma_load_4d(kt + kKVTile + x * h256::kKVBox, &v_m, &full[s], 64 * x,
                  (t_begin + i) * BK, hk, ib);
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], h256::kThreads);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(qbar, heads * 2 * kTile);
    for (int c = 0; c < heads; ++c) {
      const int ih = hk * p.g + 2 * pair + c;
      for (int x = 0; x < 4; ++x) {
        tma_load_4d(Qs + c * kTile + x * h256::kBox, &q_m, qbar, 64 * x, q0,
                    ih, ib);
        tma_load_4d(dOs + c * kTile + x * h256::kBox, &do_m, qbar, 64 * x,
                    q0, ih, ib);
      }
    }
    for (int i = 0; i < min(S, n); ++i) issue(i);
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;      // which head of the pair
  const bool active = cw < heads;
  const int ih = hk * p.g + 2 * pair + (active ? cw : 0);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int wr = q0 + 16 * warp + gr;    // the thread's rows: wr, wr + 8
  const long long row0 = ((long long)ib * p.hq + ih) * p.sq;
  const float scale_log2 = p.scale * tc::kLog2e;
  float lse2[2], dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = wr + 8 * h < p.sq;
    lse2[h] = in ? p.lse[row0 + wr + 8 * h] * tc::kLog2e : 0.f;
    dsum[h] = in ? p.delta[row0 + wr + 8 * h] : 0.f;
  }
  const unsigned char* qt = Qs + (active ? cw : 0) * kTile;
  const unsigned char* dot = dOs + (active ? cw : 0) * kTile;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    // warp 0 refills the slot of tile i - 1 once both warpgroups released
    // it (at the loop's end instead, the refill made ptxas serialise the
    // wgmma: C7520)
    if (threadIdx.x < 32 && i >= 1 && i - 1 + S < n) {
      mbar_wait(&empty[(i - 1) % S], ((i - 1) / S) & 1);
      if (lane == 0) issue(i - 1 + S);
    }
    __syncwarp();
    mbar_wait(&full[s], (i / S) & 1);
    const unsigned char* kt = ring + s * 2 * kKVTile;
    const int k0 = (t_begin + i) * BK;
    const bool full_tile = q0 + 64 <= p.sq && k0 + BK <= p.skv &&
                           (!p.causal || k0 + BK - 1 <= q0) &&
                           (p.window <= 0 || k0 > q0 + 63 - p.window);
    // S = Q K^T, dP = dO V^T (64 x 32 each)
    const uint64_t dq_q = h256::k_desc(qt), dq_do = h256::k_desc(dot);
    const uint64_t dq_k = h256::k_desc(kt);
    const uint64_t dq_v = h256::k_desc(kt + kKVTile);
    float sc[16], dp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = dp[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_m64n32k16<0, 0>(sc, h256::k_step(dq_q, h256::kBox, kk),
                            h256::k_step(dq_k, h256::kKVBox, kk));
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_m64n32k16<0, 0>(dp, h256::k_step(dq_do, h256::kBox, kk),
                            h256::k_step(dq_v, h256::kKVBox, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);
    // P = exp(scale S - LSE) where visible, 0 elsewhere; dS = P (dP - D)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, x = 4 * j + e;
        float pr = exp2f(fmaf(sc[x], scale_log2, -lse2[h]));
        if (!full_tile) {
          const int kp = k0 + 8 * j + 2 * tq + (e & 1);
          pr = visible(wr + 8 * h, kp, p.sq, p.skv, p.causal, p.window)
                   ? pr
                   : 0.f;
        }
        sc[x] = pr * (dp[x] - dsum[h]);
      }
    // dQ += dS K: dS rounded to bf16 in registers, K MN-major
    uint32_t a[2][4];
    h256::acc_to_a<32>(a, sc);
    const uint64_t dq_kt = h256::mn_desc(kt, h256::kKVBox);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_m64n256k16_rs<1>(acc, a[kk], h256::mn_step(dq_kt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(a[0]);
    fence_operands(a[1]);
    mbar_arrive(&empty[s]);
  }

  // every thread reads its accumulators (a read on a branch of its own
  // would make ptxas serialise the wgmma); a repeated head stores nothing
  bf16* dqb = p.dq + ib * p.dqs.b + ih * p.dqs.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = wr + 8 * h;
    const bool store = active && qp < p.sq;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t x = repro::pack_bf16x2(acc[4 * j + 2 * h] * p.scale,
                                            acc[4 * j + 2 * h + 1] * p.scale);
      if (store)
        *reinterpret_cast<uint32_t*>(dqb + qp * p.dqs.s + 8 * j + 2 * tq) = x;
    }
  }
}

// dK and dV at d 256, fp32 partials of one split of the group.  Block
// (split x kv head, batch row, kv tile): warpgroup 0 computes S^T, P^T
// and dV, warpgroup 1 dP^T, dS^T and dK.  Thread 0 issues the TMA copies
// of K and V and of the first Q / dO stages; warp 0 of warpgroup 1 (the
// later of the two) refills each stage once both released it.  Maps:
// q_m, do_m, k_m, v_m with 64-row boxes; lse_m, delta_m 1-D over (b, hq,
// sq).
__global__ void __launch_bounds__(h256::kThreads, 1)
flash_bwd_dkdv_h256(const __grid_constant__ CUtensorMap q_m,
                    const __grid_constant__ CUtensorMap do_m,
                    const __grid_constant__ CUtensorMap k_m,
                    const __grid_constant__ CUtensorMap v_m,
                    const __grid_constant__ CUtensorMap lse_m,
                    const __grid_constant__ CUtensorMap delta_m,
                    h256::Params p) {
  using namespace repro::sm90;
  using h256::kBox;
  using h256::kTile;
  constexpr int S = h256::kStages, R = h256::kRows;
  extern __shared__ unsigned char smem_h256[];
  unsigned char* base = smem_h256 + ((1024 - (smem_addr(smem_h256) & 1023)) &
                                     1023);
  unsigned char* Ks = base;              // 64 x 256 each
  unsigned char* Vs = Ks + kTile;
  unsigned char* ring = Vs + kTile;      // [stage][Q, dO] 64 x 256
  float* pbuf = reinterpret_cast<float*>(ring + S * 2 * kTile);
  float* ld = pbuf + 2 * R * R;          // [stage][LSE, D] slots
  uint64_t* kvbar =
      reinterpret_cast<uint64_t*>(ld + S * 2 * h256::kLdSlot);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;
  uint64_t* pfull = empty + S;           // P^T [stage] written
  uint64_t* pempty = pfull + S;          // P^T [stage] read

  // z runs slowest: the first kv tiles (causal: the most q tiles) first
  const int hk = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const int ib = blockIdx.y, k0 = blockIdx.z * R;
  const int h_first = split_head(hk, p.g, split, p.splits);
  const int nh = split_head(hk, p.g, split + 1, p.splits) - h_first;
  // the q tiles whose rows can see a key of this tile, for each head of
  // the split: iteration it is head h_first + it / nt, q tile
  // t_begin + it % nt
  const int k_last = min(k0 + R, p.skv) - 1;
  const int q_begin = p.causal ? k0 : 0;
  const int q_stop = p.window > 0 ? min(p.sq, k_last + p.window) : p.sq;
  const int t_begin = q_begin / R;
  const int t_end = q_begin < q_stop ? (q_stop + R - 1) / R : t_begin;
  const int nt = t_end - t_begin, n_it = nh * nt;
  auto issue = [&](int it) {             // iteration it into its stage
    const int s = it % S, ih = h_first + it / nt;
    const int q0 = (t_begin + it % nt) * R;
    const int row = ((ib * p.hq + ih) * p.sq + q0) & ~3;
    unsigned char* qt = ring + s * 2 * kTile;
    mbar_arrive_expect_tx(&full[s], 2 * kTile + 2 * h256::kLdBox * 4);
    for (int x = 0; x < 4; ++x) {
      tma_load_4d(qt + x * kBox, &q_m, &full[s], 64 * x, q0, ih, ib);
      tma_load_4d(qt + kTile + x * kBox, &do_m, &full[s], 64 * x, q0, ih,
                  ib);
    }
    tma_load_1d(ld + s * 2 * h256::kLdSlot, &lse_m, &full[s], row);
    tma_load_1d(ld + (s * 2 + 1) * h256::kLdSlot, &delta_m, &full[s], row);
  };

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], h256::kThreads);
      mbar_init(&pfull[s], 128);
      mbar_init(&pempty[s], 128);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(kvbar, 2 * kTile);
    for (int x = 0; x < 4; ++x) {
      tma_load_4d(Ks + x * kBox, &k_m, kvbar, 64 * x, k0, hk, ib);
      tma_load_4d(Vs + x * kBox, &v_m, kvbar, 64 * x, k0, hk, ib);
    }
    for (int it = 0; it < min(S, n_it); ++it) issue(it);
  }
  __syncthreads();

  // warpgroup 0 takes P^T and dV, 1 dS^T and dK
  const int cw = threadIdx.x / 128;
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int kw = k0 + 16 * warp + gr;    // the thread's keys: kw, kw + 8
  const float scale_log2 = p.scale * tc::kLog2e;
  // S^T = K Q^T, resp. dP^T = V dO^T; then dV += P^T dO, resp. dK +=
  // dS^T Q: the roles pick their operands, the products are the same code
  const unsigned char* a_tile = cw == 0 ? Ks : Vs;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % S, ph = (it / S) & 1;
    const int q0 = (t_begin + it % nt) * R;
    // the tile's first row within its LSE / D slot
    const int off = ((ib * p.hq + h_first + it / nt) * p.sq + q0) & 3;
    mbar_wait(&full[s], ph);
    const unsigned char* qt = ring + s * 2 * kTile;
    const unsigned char* dot = qt + kTile;
    const float* lse_s = ld + s * 2 * h256::kLdSlot + off;
    const float* d_s = lse_s + h256::kLdSlot;
    const bool full_tile = q0 + R <= p.sq && k0 + R <= p.skv &&
                           (!p.causal || k0 + R - 1 <= q0) &&
                           (p.window <= 0 || k0 > q0 + R - 1 - p.window);
    const uint64_t da = h256::k_desc(a_tile);
    const uint64_t db = h256::k_desc(cw == 0 ? qt : dot);
    float st[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_m64n64k16<0, 0>(st, h256::k_step(da, kBox, kk),
                            h256::k_step(db, kBox, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    float* pb = pbuf + s * R * R;
    if (cw == 0) {
      // P^T where visible (0 elsewhere); column c's query row reads its LSE
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float l2[2] = {lse_s[8 * j + 2 * tq] * tc::kLog2e,
                             lse_s[8 * j + 2 * tq + 1] * tc::kLog2e};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1, x = 4 * j + e;
          float pr = exp2f(fmaf(st[x], scale_log2, -l2[c]));
          if (!full_tile) {
            const int qp = q0 + 8 * j + 2 * tq + c;
            pr = visible(qp, kw + 8 * (e >> 1), p.sq, p.skv, p.causal,
                         p.window)
                     ? pr
                     : 0.f;
          }
          st[x] = pr;
        }
      }
      // hand P^T to the other warpgroup, each thread its own values
      mbar_wait(&pempty[s], ph ^ 1);
#pragma unroll
      for (int x = 0; x < 32; ++x) pb[x * 128 + t128] = st[x];
      mbar_arrive(&pfull[s]);
    } else {
      // dS^T = P^T (dP^T - D), D of the column's query row
      mbar_wait(&pfull[s], ph);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d2[2] = {d_s[8 * j + 2 * tq], d_s[8 * j + 2 * tq + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          st[x] = pb[x * 128 + t128] * (st[x] - d2[e & 1]);
        }
      }
      mbar_arrive(&pempty[s]);
    }
    uint32_t a[4][4];
    h256::acc_to_a<64>(a, st);
    const uint64_t dbt = h256::mn_desc(cw == 0 ? dot : qt, kBox);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n256k16_rs<1>(acc, a[kk], h256::mn_step(dbt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(a[kk]);
    mbar_arrive(&empty[s]);
    // warp 0 of warpgroup 1 refills the stage once both released it
    if (threadIdx.x / 32 == 4 && it + S < n_it) {
      mbar_wait(&empty[s], ph);
      if (lane == 0) issue(it + S);
    }
    __syncwarp();
  }

  // the split's partial: warpgroup 0 dV, warpgroup 1 dK (unscaled)
  float* part = split_part(p.ws, cw == 0 ? 1 : 0, split, p.splits, ib, p.b,
                           hk, p.hkv, p.skv, h256::kD);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = kw + 8 * h;
    if (kp >= p.skv) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(part + (long long)kp * h256::kD + 8 * j +
                                 2 * tq) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// The bf16 backward at d 256: the D pass, dQ, dK / dV, the sum.
int launch_h256(const Args& a, cudaStream_t stream) {
  using repro::sm90::encode_bshd;
  using repro::sm90::encode_f32_1d;
  const int g = a.hq / a.hkv;
  if (a.splits < 1 || a.splits > g || a.ws == nullptr ||
      reinterpret_cast<uintptr_t>(a.lse) % 16 ||
      reinterpret_cast<uintptr_t>(a.delta) % 16)
    return repro::kUnsupported;
  CUtensorMap q_m, do_m, k64, v64, k32, v32, lse_m, delta_m;
  const long long rows = (long long)a.b * a.hq * a.sq;
  if (!encode_bshd(&q_m, a.q, a.b, a.hq, a.sq, 256, a.qs.b, a.qs.h, a.qs.s,
                   64) ||
      !encode_bshd(&do_m, a.dout, a.b, a.hq, a.sq, 256, a.dos.b, a.dos.h,
                   a.dos.s, 64) ||
      !encode_bshd(&k64, a.k, a.b, a.hkv, a.skv, 256, a.ks.b, a.ks.h, a.ks.s,
                   64) ||
      !encode_bshd(&v64, a.v, a.b, a.hkv, a.skv, 256, a.vs.b, a.vs.h, a.vs.s,
                   64) ||
      !encode_bshd(&k32, a.k, a.b, a.hkv, a.skv, 256, a.ks.b, a.ks.h, a.ks.s,
                   h256::kBKq) ||
      !encode_bshd(&v32, a.v, a.b, a.hkv, a.skv, 256, a.vs.b, a.vs.h, a.vs.s,
                   h256::kBKq) ||
      !encode_f32_1d(&lse_m, a.lse, rows, h256::kLdBox) ||
      !encode_f32_1d(&delta_m, a.delta, rows, h256::kLdBox))
    return repro::kTensorMapRefused;
  const h256::Params p{a.lse, a.delta, static_cast<bf16*>(a.dq), a.ws, a.b,
                       a.hq, a.hkv, g, a.sq, a.skv, a.splits, a.dqs,
                       a.causal, a.window, a.scale};
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_h256, cudaFuncAttributeMaxDynamicSharedMemorySize,
      h256::kSmemDq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_h256,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             h256::kSmemDkdv);
  if (err != cudaSuccess) return (int)err;
  // D first: both kernels read it
  flash_bwd_delta_tc<<<(int)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      a.delta, a.hq, a.sq, 256, a.os, a.dos, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_h256<<<dim3((g + 1) / 2 * a.hkv, a.b, (a.sq + 63) / 64),
                      h256::kThreads, h256::kSmemDq, stream>>>(q_m, do_m, k32,
                                                               v32, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_h256<<<dim3(a.splits * a.hkv, a.b, (a.skv + 63) / 64),
                        h256::kThreads, h256::kSmemDkdv, stream>>>(
      q_m, do_m, k64, v64, lse_m, delta_m, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sum<bf16>(a, stream);
}

bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

// The splits a d 256 call takes: 1 to the group size, and a workspace of
// 2 x splits x b x hkv x skv x 256 floats.
bool splits_fit(const Args& a, int d) {
  return d != 256 || (a.splits >= 1 && a.splits <= a.hq / a.hkv &&
                      a.ws != nullptr &&
                      (long long)a.b * a.hq * a.sq < (1ll << 31));
}

}  // namespace

// C entry point (ctypes).  q, o, dout, dq (b, hq, sq, d); k, v, dk, dv
// (b, hkv, skv, d): any (b, h, s) strides in elements, head dim
// contiguous.  lse and delta (b, hq, sq) contiguous fp32: lse from the
// forward, delta a workspace this call fills with D.  At head_dim 256 the
// dK / dV kernel splits each kv head's group of query heads over
// `splits` blocks (1 .. the group's size) and `ws` is their fp32
// workspace, (2, splits, b, hkv, skv, 256) contiguous; below it reads
// neither.  Returns 0, the cudaError_t of a refused launch, or -1 for a
// head_dim / dtype it does not take (head_dim 64, 128 and 256; fp32 and
// bf16).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, float* ws, int splits, int b, int hq, int hkv, int sq,
    int skv, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, int causal, int window, float scale, int dtype,
    void* stream) {
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, delta, ws, splits, b, hq,
               hkv, sq, skv, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
               {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss},
               {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
               {dv_sb, dv_sh, dv_ss}, causal, window, scale};
  if (!splits_fit(a, d)) return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) return dispatch_d<float>(d, a, st);
  if (dtype == repro::kBF16) return dispatch_d<__nv_bfloat16>(d, a, st);
  return repro::kUnsupported;
}

// The tensor-core instance: bf16, head_dim 64, 128 or 256, q, k, v, o, dout,
// dq, dk and dv 16-byte aligned with (b, h, s) strides in multiples of 8
// elements (rows are copied in 16-byte chunks, or by TMA at d 256, and
// written in bf16 pairs); at d 256 lse 16-byte aligned too.  Same
// arguments and returns as above, less the dtype, and -2 when the driver
// refuses a tensor map (d 256).
extern "C" int repro_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, float* ws, int splits, int b, int hq, int hkv, int sq,
    int skv, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, delta, ws, splits, b, hq,
               hkv, sq, skv, {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
               {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}, {do_sb, do_sh, do_ss},
               {dq_sb, dq_sh, dq_ss}, {dk_sb, dk_sh, dk_ss},
               {dv_sb, dv_sh, dv_ss}, causal, window, scale};
  if (!aligned16(a.q, a.qs) || !aligned16(a.k, a.ks) ||
      !aligned16(a.v, a.vs) || !aligned16(a.o, a.os) ||
      !aligned16(a.dout, a.dos) || !aligned16(a.dq, a.dqs) ||
      !aligned16(a.dk, a.dks) || !aligned16(a.dv, a.dvs) ||
      !splits_fit(a, d))
    return repro::kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_tc<64>(a, st);
    case 128:
      return launch_tc<128>(a, st);
    case 256:
      return launch_h256(a, st);
    default:
      return repro::kUnsupported;
  }
}
