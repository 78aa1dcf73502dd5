// Paged-attention decode for Hopper (sm_90a): one query token per batch
// row against a KV pool addressed by block tables, fp32 online softmax.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
// `paged_attention` (the Pallas TPU kernel, pl.pallas_call at :148).  Same
// function and block-table ABI: q (b, hq, d); k/v pages (hkv, n_pages,
// block_tokens, d); position p of row b lives in page block_tables[b,
// p / block_tokens] at offset p % block_tokens; lengths[b] positions are
// valid; the window is relative to the query at position lengths[b] - 1;
// a row with lengths[b] == 0 gets exact zeros (acc / max(l, 1e-30) with
// acc = 0), which the batched executor relies on for its inactive rows.
//
// What bounds it on the H100: bytes.  Every valid K and V row is read
// once and used for g = hq / hkv dot products of length d (3 for
// smollm-135m), about 3 flops per byte, far below the ~295 flops per byte
// where the tensor cores would become the limit.  At the serving path's
// shapes (8 rows, 3 kv heads, a few pages each) the whole call moves well
// under a megabyte, so launch latency and the small grid dominate.
//
// Design: one block of 128 threads per (batch row, kv head) holds all g
// query heads of the group, so each K/V page is read from device memory
// once for the whole group.  The block reads its own length and
// block-table row (the GPU has no scalar prefetch) and loops over pages
// from the window's first page to ceil(length / block_tokens); pages past
// the length are never touched.  Each page is staged in shared memory as
// fp32 (K rows padded by one float against bank conflicts); thread t
// scores key t for all g heads, block-wide max and sum reductions update
// the fp32 running max and denominator, and the g x d accumulator is
// spread over the threads.  The grid is b * hkv blocks (24 at width 8 for
// smollm-135m), far below the 132 SMs; splitting long contexts over pages
// with a second combining pass is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;            // also the largest page it takes
constexpr int kWarps = kThreads / 32;

template <int D, int G>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kThreads * (D + 1) + kThreads * D + G * D +
                          G * kThreads + kWarps * G + 2 * G);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ tables,
             const int* __restrict__ lengths, T* __restrict__ o, int hkv,
             int n_pages, int btok, int nb, int window, float scale) {
  using repro::kNegInf;
  constexpr int kKS = D + 1;
  constexpr int kPairs = (G * D + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  float* Ks = smem;                      // btok x kKS
  float* Vs = Ks + kThreads * kKS;       // btok x D
  float* Qs = Vs + kThreads * D;         // G x D, pre-scaled
  float* Ps = Qs + G * D;                // G x btok probabilities
  float* red = Ps + G * kThreads;        // kWarps x G partials
  float* As = red + kWarps * G;          // G rescale factors
  float* Ls = As + G;                    // G final denominators

  const int ih = blockIdx.x, ib = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[ib];
  const long long head = (long long)ib * hkv + ih;   // (b, hkv) group
  const T* qg = q + head * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    Qs[i] = repro::to_f32(qg[i]) * scale;

  const int first = window > 0 ? max(0, len - window) : 0;
  const int p_begin = first / btok;
  const int p_end = min((len + btok - 1) / btok, nb);
  const long long page_elems = (long long)btok * D;
  const T* kh = k_pages + (long long)ih * n_pages * page_elems;
  const T* vh = v_pages + (long long)ih * n_pages * page_elems;

  float m[G], l[G], acc[kPairs];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < kPairs; ++a) acc[a] = 0.f;

  for (int p = p_begin; p < p_end; ++p) {
    const long long page = tables[(long long)ib * nb + p];
    // the keys of this page that are in the row's span (and window)
    const int j_lo = max(0, first - p * btok);
    const int j_hi = min(btok, len - p * btok);
    __syncthreads();                     // last page consumed, Qs staged
    const T* kpg = kh + page * page_elems;
    const T* vpg = vh + page * page_elems;
    for (int i = tid; i < btok * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Ks[r * kKS + c] = repro::to_f32(kpg[i]);
      Vs[i] = repro::to_f32(vpg[i]);
    }
    __syncthreads();

    const bool ok = tid >= j_lo && tid < j_hi;
    float s[G];
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] = 0.f;
    if (ok) {
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float kv = Ks[tid * kKS + c];
#pragma unroll
        for (int i = 0; i < G; ++i) s[i] = fmaf(Qs[i * D + c], kv, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float x = repro::warp_max(ok ? s[i] : kNegInf);
      if (lane == 0) red[warp * G + i] = x;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float mx = red[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w * G + i]);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      s[i] = ok ? expf(s[i] - m_new) : 0.f;
      Ps[i * kThreads + tid] = s[i];
      l[i] *= alpha;
      m[i] = m_new;
      if (tid == 0) As[i] = alpha;
    }
    __syncthreads();                     // everyone has read red
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float x = repro::warp_sum(s[i]);
      if (lane == 0) red[warp * G + i] = x;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w * G + i];
      l[i] += sum;
    }
    // acc = acc * alpha + P V over this page's keys in span
#pragma unroll
    for (int a = 0; a < kPairs; ++a) {
      const int pair = tid + a * kThreads;
      if (pair < G * D) {
        const int i = pair / D, c = pair % D;
        float x = acc[a] * As[i];
        const float* pi = Ps + i * kThreads;
        for (int j = j_lo; j < j_hi; ++j) x = fmaf(pi[j], Vs[j * D + c], x);
        acc[a] = x;
      }
    }
  }

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) Ls[i] = fmaxf(l[i], 1e-30f);
  }
  __syncthreads();
  T* og = o + head * G * D;
#pragma unroll
  for (int a = 0; a < kPairs; ++a) {
    const int pair = tid + a * kThreads;
    if (pair < G * D) og[pair] = repro::from_f32<T>(acc[a] / Ls[pair / D]);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* o, int b, int hkv, int n_pages, int btok,
           int nb, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, G>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, b);
  paged_decode<T, D, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(o), hkv,
      n_pages, btok, nb, window, scale);
  return (int)cudaGetLastError();
}

#define REPRO_PAGED_ARGS \
  q, kp, vp, tables, lengths, o, b, hkv, n_pages, btok, nb, window, scale, st

template <typename T, int D>
int dispatch_g(int g, const void* q, const void* kp, const void* vp,
               const int* tables, const int* lengths, void* o, int b, int hkv,
               int n_pages, int btok, int nb, int window, float scale,
               cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, D, 1>(REPRO_PAGED_ARGS);
    case 2: return launch<T, D, 2>(REPRO_PAGED_ARGS);
    case 3: return launch<T, D, 3>(REPRO_PAGED_ARGS);
    case 4: return launch<T, D, 4>(REPRO_PAGED_ARGS);
    case 5: return launch<T, D, 5>(REPRO_PAGED_ARGS);
    case 6: return launch<T, D, 6>(REPRO_PAGED_ARGS);
    case 7: return launch<T, D, 7>(REPRO_PAGED_ARGS);
    case 8: return launch<T, D, 8>(REPRO_PAGED_ARGS);
    default: return repro::kUnsupported;
  }
}

template <typename T>
int dispatch_d(int d, int g, const void* q, const void* kp, const void* vp,
               const int* tables, const int* lengths, void* o, int b, int hkv,
               int n_pages, int btok, int nb, int window, float scale,
               cudaStream_t st) {
  switch (d) {
    case 16: return dispatch_g<T, 16>(g, REPRO_PAGED_ARGS);
    case 32: return dispatch_g<T, 32>(g, REPRO_PAGED_ARGS);
    case 64: return dispatch_g<T, 64>(g, REPRO_PAGED_ARGS);
    case 128: return dispatch_g<T, 128>(g, REPRO_PAGED_ARGS);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// C entry point (ctypes).  q and the pools must be contiguous; tables and
// lengths int32.  Returns 0 on success, the cudaError_t of a refused
// launch, or -1 for a head_dim / group size / dtype no instance takes.
extern "C" int repro_paged_attention_decode(
    const void* q, const void* kp, const void* vp, const int* tables,
    const int* lengths, void* o, int b, int hq, int hkv, int n_pages,
    int btok, int nb, int d, int window, float scale, int dtype,
    void* stream) {
  if (btok < 1 || btok > kThreads || hq % hkv != 0) return repro::kUnsupported;
  const int g = hq / hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_d<float>(d, g, REPRO_PAGED_ARGS);
  if (dtype == repro::kBF16)
    return dispatch_d<__nv_bfloat16>(d, g, REPRO_PAGED_ARGS);
  return repro::kUnsupported;
}
