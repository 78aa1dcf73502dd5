// Flash-attention forward for Hopper (sm_90a): causal / sliding-window GQA
// with an fp32 online softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention` (the Pallas TPU kernel, pl.pallas_call at :92).  Same
// function: q (b, hq, sq, d), k/v (b, hkv, skv, d), query head ih reads kv
// head ih / g, masks k < skv, k <= q (causal) and k > q - window, softmax
// and accumulation in fp32, output in the input dtype.  Forward only, as
// the Pallas package has no backward either.
//
// What bounds it on the H100: at the serving path's prefill shapes
// (smollm-135m: hq 9, hkv 3, d 64, prompts of a few hundred tokens) the
// whole call moves under a megabyte and does ~10^8 flops, so the memory
// and tensor-core bounds are both well under a microsecond; the real
// limit is latency: launch, one pass over the kv tiles, and a grid of a
// few dozen blocks on 132 SMs.
//
// recurrentgemma-2b's 8 attention layers (hq 10, hkv 1, d 256, window
// 2048) are the same latency-bound case at four times the head width.
//
// Design: one block per (b, hq, 64-row q tile); 8 warps, each owning 8
// query rows.  A loop over kv tiles of kBK = 128 keys (64 at d 256, where
// a 128-key tile would need 328 KB of shared memory, over the 227 KB a
// block may opt into) inside the block takes the
// place of the TPU's sequential kv grid dimension; it starts at the
// window's first tile and stops at the causal diagonal, so fully masked
// tiles are never loaded.  Each tile's K and V are staged once in shared
// memory as fp32 (K rows padded by one float, so lanes reading different
// keys hit different banks); lane j scores keys j, j+32, j+64, j+96 for
// all 8 of its warp's rows, and the PV product broadcasts each
// probability by warp shuffle.  Arithmetic is fp32 on the CUDA cores —
// simple and exact against the fp32 plain version; tensor cores (wgmma),
// TMA and a deeper pipeline are later work.  Strides are arguments, so
// the model's (b, s, h, d) tensors are read in place without a transpose.
#include "common.cuh"

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
          const T* __restrict__ v, T* __restrict__ o, int g, int sq,
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
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int g, int sq, int skv, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), g, sq, skv, qs, ks, vs,
      os, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int b, int hq, int g, int sq, int skv, Strides qs, Strides ks,
               Strides vs, Strides os, int causal, int window, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, g, sq, skv, qs, ks, vs, os,
                           causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, g, sq, skv, qs, ks, vs, os,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, g, sq, skv, qs, ks, vs, os,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, g, sq, skv, qs, ks, vs, os,
                            causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, b, hq, g, sq, skv, qs, ks, vs, os,
                            causal, window, scale, stream);
    default:
      return repro::kUnsupported;
  }
}

}  // namespace

// C entry point (ctypes).  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for a head_dim / dtype no instance takes.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    int dtype, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const int g = hq / hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_d<float>(d, q, k, v, o, b, hq, g, sq, skv, qs, ks, vs, os,
                             causal, window, scale, st);
  if (dtype == repro::kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, g, sq, skv, qs, ks,
                                     vs, os, causal, window, scale, st);
  return repro::kUnsupported;
}
