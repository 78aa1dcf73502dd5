// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA
// with an fp32 online softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention` (the Pallas TPU kernel, pl.pallas_call at :92).  Same
// function: q (b, hq, sq, d), k/v (b, hkv, skv, d), query head ih reads kv
// head ih / g, masks k < skv, k <= q (causal) and k > q - window, softmax
// and accumulation in fp32, output in the input dtype.  Forward only, as
// the Pallas package has no backward either; for training, either
// instance also writes each row's log-sum-exp (`lse`, fp32 (b, hq, sq),
// natural log of the softmax denominator in the units of the scaled
// scores: m + log(l)) when given a non-null pointer, which the backward
// (flash_attention_bwd.cu) reads.  A null pointer writes nothing and
// leaves every output bit as it was.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (smollm-135m: hq 9, hkv 3, d 64; deepseek-moe-16b: hq 16, d 128;
// recurrentgemma-2b: hq 10, hkv 1, d 256; prompts of a few hundred
// tokens) a call moves a few megabytes at most and does ~10^8-10^9
// flops, so the memory and tensor-core bounds are both around a
// microsecond; the real limit is latency: a grid of a few dozen blocks on
// 132 SMs, each walking 3-5 kv tiles one after another, so what counts is
// the time of one tile.
//
// Both instances: one block per (64-row q tile, head, batch row).  A loop
// over kv tiles of kBK = 128 keys (kBK256 = 64 at d 256, where 128-key
// tiles do not fit shared memory) inside the block takes the place of the
// TPU's sequential kv grid dimension; it starts at the window's first
// tile and stops at the causal diagonal, so fully masked tiles are never
// loaded.  Strides are arguments, so the model's (b, s, h, d) tensors are
// read in place without a transpose.
//
// * `flash_fwd_tc`, bf16 at d 64, 128 and 256 (FlashAttention-2 form): it
//   cuts the time of a tile by running both products on the tensor cores,
//   keeping the tiles in bf16, and giving each tile to twice the warps.
//   Eight warps: warp w holds query rows 16 (w % 4) .. +15 and takes the
//   keys of half w / 4 of every kv tile with its own online softmax, so a
//   tile's MMAs are spread over two warps per SM sub-partition (one would
//   leave the tensor pipe waiting on its own fragment loads); the two
//   halves' (max, sum, accumulator) merge through shared memory at the
//   end.  K and V tiles stream into XOR-swizzled shared memory through a
//   double-buffered cp.async ring (tile t + 1 loads while tile t is
//   multiplied); keys past skv are zero-filled by the copy.  S = Q K^T
//   runs on mma.sync m16n8k16 with Q's fragments loaded once through
//   ldmatrix and held in registers (at d 256 they are re-read from shared
//   memory per tile: 128 accumulator registers for O leave no room) and
//   K's through plain ldmatrix as the "col" B operand.  Scale (on the
//   fp32 scores, in the log2 domain), masks and the online softmax work
//   on the accumulator fragments; row max and sum are reduced over the
//   four lanes that share a row.  P is rounded to bf16 in registers and is
//   directly the A operand of P V (two n8 accumulator tiles are one k16 A
//   fragment); V's fragments come through ldmatrix.trans.  The
//   denominator sums the rounded P, so the weights applied to V sum to
//   one.  A warp skips the half-tiles that hold no key for its rows (past
//   the causal diagonal, before the window, past skv).
// * `flash_fwd`, fp32 (and bf16 at other head dims or strides) on the
//   CUDA cores, exact against the fp32 plain version: 8 warps of 8 rows;
//   each tile's K and V staged in shared memory as fp32 (K rows padded by
//   one float against bank conflicts); lane j scores keys j, j+32, ...
//   for all 8 of its warp's rows, and the P V product broadcasts each
//   probability by warp shuffle.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 128;                 // kv tile (the Pallas block_k), d <= 128
constexpr int kBK256 = 64;               // kv tile at d 256 (shared memory)
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;      // query rows per warp
constexpr int kThreads = kWarps * 32;

template <int D>
__host__ __device__ constexpr int kv_tile() {
  return D <= 128 ? kBK : kBK256;
}

struct Strides {
  long long b, h, s;                     // in elements; d is contiguous
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kv_tile<D>() * (2 * D + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int g, int sq,
          int skv, Strides qs, Strides ks, Strides vs, Strides os,
          int causal, int window, float scale) {
  using repro::kNegInf;
  constexpr int BK = kv_tile<D>();
  constexpr int kKeysPerLane = BK / 32;
  constexpr int kDPL = (D + 31) / 32;    // output dims per lane
  constexpr int kKS = D + 1;             // padded K row stride
  extern __shared__ float smem[];
  float* Qs = smem;                      // kBQ x D, pre-scaled
  float* Ks = Qs + kBQ * D;              // BK x kKS
  float* Vs = Ks + BK * kKS;             // BK x D

  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // whether the lane's dd-th output dim exists (D < 32 leaves lanes idle)
  auto has_dim = [lane](int dd) { return D % 32 == 0 || lane + 32 * dd < D; };
  const T* qb = q + ib * qs.b + ih * qs.h;
  const T* kb = k + ib * ks.b + (ih / g) * ks.h;
  const T* vb = v + ib * vs.b + (ih / g) * vs.h;
  T* ob = o + ib * os.b + ih * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[i] = q0 + r < sq
                ? repro::to_f32(qb[(long long)(q0 + r) * qs.s + c]) * scale
                : 0.f;
  }

  // the kv tiles this q tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  float m[kRows], l[kRows], acc[kRows][kDPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();                     // last tile consumed, Qs staged
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < skv;
      Ks[r * kKS + c] = in ? repro::to_f32(kb[(long long)(k0 + r) * ks.s + c])
                           : 0.f;
      Vs[r * D + c] = in ? repro::to_f32(vb[(long long)(k0 + r) * vs.s + c])
                         : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[kKeysPerLane];
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j)
        kv[j] = Ks[(lane + 32 * j) * kKS + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = Qs[(warp * kRows + r) * D + c];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j)
          s[r][j] = fmaf(qv, kv[j], s[r][j]);
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + warp * kRows + r;
      bool ok[kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int kp = k0 + lane + 32 * j;
        ok[j] = kp < skv && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        if (ok[j]) mx = fmaxf(mx, s[r][j]);
      }
      mx = repro::warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        s[r][j] = ok[j] ? expf(s[r][j] - m_new) : 0.f;
        sum += s[r][j];
      }
      l[r] = alpha * l[r] + repro::warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd) acc[r][dd] *= alpha;
    }

    // acc += P V: key kk's probability lives in lane kk % 32, slot kk / 32
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        const int kk = j * 32 + src;
        float vv[kDPL];
#pragma unroll
        for (int dd = 0; dd < kDPL; ++dd)
          vv[dd] = has_dim(dd) ? Vs[kk * D + lane + 32 * dd] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = __shfl_sync(0xffffffffu, s[r][j], src);
#pragma unroll
          for (int dd = 0; dd < kDPL; ++dd)
            acc[r][dd] = fmaf(p, vv[dd], acc[r][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + warp * kRows + r;
    if (qp < sq) {
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < kDPL; ++dd)
        if (has_dim(dd))
          ob[(long long)qp * os.s + lane + 32 * dd] =
              repro::from_f32<T>(acc[r][dd] / den);
      // l is the whole row's sum here (warp_sum); -inf for a row that
      // sees no key
      if (lse != nullptr && lane == 0)
        lse[((long long)ib * gridDim.y + ih) * sq + qp] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int hq, int g, int sq, int skv, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, g, sq, skv, qs, ks,
      vs, os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int hq, int g, int sq, int skv, Strides qs,
               Strides ks, Strides vs, Strides os, int causal, int window,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                           os, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                           os, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                           os, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                            os, causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                            os, causal, window, scale, stream);
    default:
      return repro::kUnsupported;
  }
}

// --- the tensor-core instance (bf16) ----------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {
// 8 warps: warp w owns query rows 16 (w % 4) .. +15 of the q tile and the
// keys of half w / 4 of every kv tile, with its own online softmax; the
// two halves' partial results merge at the end
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr bool q_in_regs() {
  return D <= 128;
}

template <int D>
constexpr int smem_bytes() {             // Q, then 2 stages of K and V
  return 2 * (kBQ * D + 2 * 2 * kv_tile<D>() * D);
}
}  // namespace tc

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int g, int sq,
             int skv, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, float scale_log2) {
  using repro::kNegInf;
  using repro::swz;
  constexpr int BK = kv_tile<D>();
  constexpr int HK = BK / 2;             // keys of a tile per warp
  constexpr int DC = D / 8;              // 16-byte chunks per row
  constexpr int NS = HK / 8;             // n8 score tiles of a warp's half
  constexpr int NO = D / 8;              // n8 output tiles
  constexpr int KD = D / 16;             // k16 steps of Q K^T
  constexpr int KB = HK / 16;            // k16 steps of P V
  constexpr int kTileBytes = BK * D * 2;
  constexpr int kThreads = tc::kThreads;
  static_assert(DC % 8 == 0, "the swizzle needs rows of 8+ chunks");
  static_assert(4 * 16 * D * 4 + 2 * 4 * 2 * 32 * 4 <= 4 * kTileBytes,
                "the merge buffer reuses the K/V stages");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* Qs = smem_tc;                      // kBQ x D
  unsigned char* KVs = smem_tc + kBQ * D * 2;       // [stage][K, V] BK x D

  const int ih = blockIdx.y, ib = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;  // row group, key half
  const int gr = lane >> 2, tq = lane & 3;    // fragment row / column pair
  const int wr0 = q0 + rg * 16;               // the warp's first query row
  const bf16* qb = q + ib * qs.b + ih * qs.h;
  const bf16* kb = k + ib * ks.b + (ih / g) * ks.h;
  const bf16* vb = v + ib * vs.b + (ih / g) * vs.h;
  bf16* ob = o + ib * os.b + ih * os.h;

  // the kv tiles this q tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  // one kv tile's K or V rows into a stage; keys past skv zero-filled
  auto load_rows = [&](unsigned char* dst, const bf16* src, long long ss,
                       int t) {
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK * DC / kThreads; ++j) {
      const int i = j * kThreads + tid;
      const int r = i / DC, c = i % DC;
      const bool in = k0 + r < skv;
      const long long row = in ? k0 + r : 0;
      repro::cp_async_16(dst + swz(r, c, DC), src + row * ss + c * 8,
                         in ? 16 : 0);
    }
  };
  auto k_stage = [&](int stage) { return KVs + stage * 2 * kTileBytes; };
  auto v_stage = [&](int stage) { return k_stage(stage) + kTileBytes; };

  // one cp.async group per tile: (Q and) K and V; tile t + 1 loads while
  // tile t is multiplied
  for (int i = tid; i < kBQ * DC; i += kThreads) {
    const int r = i / DC, c = i % DC;
    const bool in = q0 + r < sq;
    const long long row = in ? q0 + r : 0;
    repro::cp_async_16(Qs + swz(r, c, DC), qb + row * qs.s + c * 8,
                       in ? 16 : 0);
  }
  if (t_begin < t_end) {
    load_rows(k_stage(0), kb, ks.s, t_begin);
    load_rows(v_stage(0), vb, vs.s, t_begin);
  }
  repro::cp_async_commit();

  const repro::FragLane fa = repro::frag_lane_a(lane);
  const repro::FragLane fb = repro::frag_lane_b(lane);
  float m[2] = {kNegInf, kNegInf};       // rows gr, gr + 8 (log2 units)
  float l[2] = {0.f, 0.f};               // this lane's part of the sums
  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  uint32_t qf[tc::q_in_regs<D>() ? KD : 1][4];

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    repro::cp_async_wait<0>();           // tile t (and Q) landed
    __syncthreads();                     // ... for all; tile t - 1 is free
    if (t + 1 < t_end) {
      load_rows(k_stage(stage ^ 1), kb, ks.s, t + 1);
      load_rows(v_stage(stage ^ 1), vb, vs.s, t + 1);
    }
    repro::cp_async_commit();
    if constexpr (tc::q_in_regs<D>()) {
      if (t == t_begin) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          repro::ldmatrix_x4(qf[kd],
                             Qs + repro::swz_frag(fa, rg * 16, kd * 2, DC));
      }
    }
    const int k0 = t * BK + half * HK;   // the warp's first key
    // whether the warp's half holds a key for one of its rows
    const bool work =
        wr0 < sq && k0 < skv && !(causal && k0 > wr0 + 15) &&
        !(window > 0 && k0 + HK - 1 <= wr0 - window);
    if (!work) continue;
    const unsigned char* kt = k_stage(stage) + half * HK * DC * 16;
    // S = Q K^T (fp32 accumulators)
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (tc::q_in_regs<D>()) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
      } else {
        repro::ldmatrix_x4(a, Qs + repro::swz_frag(fa, rg * 16, kd * 2,
                                                   DC));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        repro::ldmatrix_x4(b, kt + repro::swz_frag(fb, np * 16, kd * 2, DC));
        repro::mma_bf16(s[2 * np], a, b[0], b[1]);
        repro::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, and the online-softmax update of the lane's two rows
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = wr0 + gr + 8 * (i >> 1);
        const int kp = k0 + nt * 8 + 2 * tq + (i & 1);
        const bool ok = kp < skv && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        s[nt][i] = ok ? s[nt][i] * scale_log2 : kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      // a row with no valid key yet: every score is kNegInf, p = 0
      m_use[h] = m_new == kNegInf ? 0.f : m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha[i >> 1];
    // p rounded to bf16 once: the denominator sums what P V multiplies
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = __bfloat162float(
            __float2bfloat16(exp2f(s[nt][i] - m_use[i >> 1])));
        l[i >> 1] += s[nt][i];
      }
    // two n8 accumulator tiles are the A fragment of one k16 step
    uint32_t pf[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
      repro::acc_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);

    // O += P V
    const unsigned char* vt = v_stage(stage) + half * HK * DC * 16;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        repro::ldmatrix_x4_trans(
            b, vt + repro::swz_frag(fa, kk * 16, dp * 2, DC));
        repro::mma_bf16(acc[2 * dp], pf[kk], b[0], b[1]);
        repro::mma_bf16(acc[2 * dp + 1], pf[kk], b[2], b[3]);
      }
  }
  repro::cp_async_wait<0>();

  // merge the two key halves: half 1 leaves (m, l, acc) in shared memory
  // (the K/V stages, free now) in fragment order, half 0 combines and
  // writes the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* xacc = reinterpret_cast<float*>(KVs) + rg * NO * 4 * 32;
  float* xml = reinterpret_cast<float*>(KVs) + 4 * NO * 4 * 32 +
               rg * 2 * 2 * 32;
  __syncthreads();                       // every warp is done with K/V
  if (half == 1) {
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) xacc[(nt * 4 + i) * 32 + lane] = acc[nt][i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xml[h * 32 + lane] = m[h];
      xml[(2 + h) * 32 + lane] = l[h];
    }
  }
  __syncthreads();
  if (half == 1) return;
  float c0[2], c1[2], inv[2], row_lse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = xml[h * 32 + lane], l1 = xml[(2 + h) * 32 + lane];
    const float mm = fmaxf(m[h], m1);
    c0[h] = mm == kNegInf ? 0.f : exp2f(m[h] - mm);
    c1[h] = mm == kNegInf ? 0.f : exp2f(m1 - mm);
    const float den = c0[h] * l[h] + c1[h] * l1;
    inv[h] = 1.f / fmaxf(den, 1e-30f);
    // the LSE this instance makes: den sums the bf16-rounded P (what P V
    // multiplies), so exp(S - LSE) recomputed in fp32 by the backward is
    // the unrounded P over that sum; its rows sum to 1 within the bf16
    // rounding of P (relative 2^-9 a term).  -inf for a row that sees no
    // key.
    row_lse[h] = mm * tc::kLn2 + logf(den);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = wr0 + gr + 8 * h;
    if (qp >= sq) continue;
    if (lse != nullptr && tq == 0)
      lse[((long long)ib * gridDim.y + ih) * sq + qp] = row_lse[h];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const float o0 = c0[h] * acc[nt][2 * h] +
                       c1[h] * xacc[(nt * 4 + 2 * h) * 32 + lane];
      const float o1 = c0[h] * acc[nt][2 * h + 1] +
                       c1[h] * xacc[(nt * 4 + 2 * h + 1) * 32 + lane];
      *reinterpret_cast<uint32_t*>(ob + qp * os.s + nt * 8 + 2 * tq) =
          repro::pack_bf16x2(o0 * inv[h], o1 * inv[h]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int hq, int g, int sq, int skv, Strides qs,
              Strides ks, Strides vs, Strides os, int causal, int window,
              float scale, cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_tc<D><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, g, sq, skv,
      qs, ks, vs, os, causal, window, scale * tc::kLog2e);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

// C entry point (ctypes).  `lse` is null, or (b, hq, sq) contiguous fp32
// for each row's log-sum-exp.  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a head_dim / dtype no instance takes.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int hq, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const int g = hq / hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_d<float>(d, q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                             os, causal, window, scale, st);
  if (dtype == repro::kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, hq, g, sq, skv, qs,
                                     ks, vs, os, causal, window, scale, st);
  return repro::kUnsupported;
}

// The tensor-core instance: bf16, head_dim 64, 128 or 256, every tensor
// 16-byte aligned with strides in multiples of 8 elements (each row is
// copied in 16-byte chunks).  Same arguments and returns as above, less
// the dtype.
extern "C" int repro_flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int hq, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) ||
      !aligned16(o, os))
    return repro::kUnsupported;
  const int g = hq / hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                           os, causal, window, scale, st);
    case 128:
      return launch_tc<128>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                            os, causal, window, scale, st);
    case 256:
      return launch_tc<256>(q, k, v, o, lse, b, hq, g, sq, skv, qs, ks, vs,
                            os, causal, window, scale, st);
    default:
      return repro::kUnsupported;
  }
}
