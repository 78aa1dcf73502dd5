// Paged-attention decode for Hopper (sm_90a): one query token per batch
// row against a KV pool addressed by block tables, fp32 online softmax.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
// `paged_attention` (the Pallas TPU kernel, pl.pallas_call at :148).  Same
// function and block-table ABI: q (b, hq, d); k/v pages (hkv, n_pages,
// block_tokens, d); position p of row b lives in page block_tables[b,
// p / block_tokens] at offset p % block_tokens; lengths[b] positions are
// valid; the window is relative to the query at position lengths[b] - 1;
// a row with no key in its span (lengths[b] == 0) gets exact zeros, which
// the batched executor relies on for its inactive rows.
//
// What bounds it on the H100: bytes, and at the serving shapes latency.
// Every valid K and V row is read once and used for g = hq / hkv dot
// products of length d: 1-3 flops per byte, two orders of magnitude below
// the ~295 flops per byte where the tensor cores would become the limit.
// An m16n8k16 tile would fill 1-3 of its 16 rows with the g query heads,
// so the kernel runs on the CUDA cores.  At smollm-135m's decode (8 rows,
// 3 kv heads, up to 3 pages) the call moves ~0.8 MB, so what sets its time
// is how many SMs take part and how many round trips to memory each makes.
//
// Design: the grid is (splits, hkv, b).  A split is `pps` consecutive
// pages of a row's table (one page unless b * hkv * nb would exceed about
// eight blocks per SM; the wrapper's `plan_splits` doubles it until it
// does not), so a row's pages are read by many blocks at once.  A block
// whose pages hold no key of [max(0, len - window), len) returns at once.
// Inside a block (4 warps), each lane reads 16 bytes of a K or V row
// straight from the pool (8 bf16 or 4 fp32), so d / 8 (or d / 4) adjacent
// lanes cover one key and a warp step covers 32 / that many consecutive
// keys; the 4 warps take interleaved steps of the page, and each lane
// issues the loads of `U` steps before it uses any.  The g query heads'
// slices sit pre-scaled in registers; a score is reduced over its key's
// lanes with xor shuffles; each key's lane group keeps its own fp32
// (max, sum, acc) per head, merged over the warp with shuffles and over
// the 4 warps through shared memory once per block.  No page is staged
// in shared memory and no barrier sits in the key loop.
//
// Merging the splits, in the same launch: a row whose span lies in one
// split writes its output directly.  Otherwise each live split writes its
// (acc[g x d], max, sum) in fp32 to the workspace, fences, and takes a
// ticket from the row's per-(row, kv head) counter; the block that draws
// the last ticket merges every split in split order (so two calls are bit
// identical: no atomics on data), writes the output and resets the counter
// to 0 for the next call.  Calls on one stream run one after another, so
// one counter array per stream serves them all; the wrapper keeps one of
// fixed size per (device, stream) and never replaces it.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// 16 bytes of the pool or of q as floats: 4 fp32 or 8 bf16
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_split(const T* __restrict__ q, const T* __restrict__ k_pages,
            const T* __restrict__ v_pages, const int* __restrict__ tables,
            const int* __restrict__ lengths, T* __restrict__ o,
            float* __restrict__ ws, int* __restrict__ counters, int hkv,
            int n_pages, int btok, int nb, int pps, int window,
            float scale) {
  using repro::kNegInf;
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int LPK = D / VEC;           // lanes per key
  constexpr int KPW = 32 / LPK;          // keys per warp step
  constexpr int KPS = KPW * kWarps;      // keys per block step
  constexpr int U = G > 4 ? 2 : 4;       // block steps in flight per lane
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head_dim");
  __shared__ float s_acc[kWarps][G * D];
  __shared__ float s_m[kWarps][G], s_l[kWarps][G];
  __shared__ int s_is_last;

  const int split = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kk = lane / LPK, c = lane % LPK;   // key in the step, slice
  const long long head = (long long)ib * hkv + ih;   // (b, hkv) group
  // the length, the split's first table entry and q in one round trip
  // (none depends on another), before anything waits on the length
  const int len = lengths[ib];
  const int page0 = tables[(long long)ib * nb + split * pps];
  uint4 qraw[G];
#pragma unroll
  for (int i = 0; i < G; ++i)
    qraw[i] = load16(q + (head * G + i) * D + c * VEC);

  const int first = window > 0 ? max(0, len - window) : 0;
  const int end = min(len, nb * btok);
  T* og = o + head * G * D;
  if (end <= first) {                    // no key in span: exact zeros
    if (split == 0)
      for (int i = tid; i < G * D; i += kThreads)
        og[i] = repro::from_f32<T>(0.f);
    return;
  }
  const int split_keys = pps * btok;
  const int s_first = first / split_keys, s_last = (end - 1) / split_keys;
  if (split < s_first || split > s_last) return;

  float qr[G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    unpack(qraw[i], qr[i]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[i][e] *= scale;
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }

  const long long page_elems = (long long)btok * D;
  const T* kh = k_pages + (long long)ih * n_pages * page_elems + c * VEC;
  const T* vh = v_pages + (long long)ih * n_pages * page_elems + c * VEC;
  const int p_end = min(split * pps + pps, nb);
  for (int p = split * pps; p < p_end; ++p) {
    // the keys of this page that are in the row's span (and window)
    const int lo = max(first - p * btok, 0), hi = min(end - p * btok, btok);
    if (hi <= lo) continue;
    const long long page =
        p == split * pps ? page0 : tables[(long long)ib * nb + p];
    const T* kpg = kh + page * page_elems;
    const T* vpg = vh + page * page_elems;
    for (int j0 = lo / KPS * KPS; j0 < hi; j0 += U * KPS) {
      uint4 kr[U], vr[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * KPS + warp * KPW + kk;
        ok[u] = j >= lo && j < hi;
        const uint4 zero = make_uint4(0, 0, 0, 0);
        kr[u] = ok[u] ? load16(kpg + (long long)j * D) : zero;
        vr[u] = ok[u] ? load16(vpg + (long long)j * D) : zero;
      }
      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        unpack(kr[u], kf);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) x = fmaf(qr[i][e], kf[e], x);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          s[u][i] = x;
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) mx = fmaxf(mx, s[u][i]);
        const float alpha = expf(m[i] - mx);
        m[i] = mx;
        l[i] *= alpha;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[VEC];
        unpack(vr[u], vf);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float pr = ok[u] ? expf(s[u][i] - m[i]) : 0.f;
          l[i] += pr;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][e] = fmaf(pr, vf[e], acc[i][e]);
        }
      }
    }
  }

  // merge the warp's key groups (lanes c, c + LPK, ...), then the warps
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      const float a = expf(m[i] - mn), b = expf(mo - mn);
      l[i] = l[i] * a + lo * b;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * a + ao * b;
      }
      m[i] = mn;
    }
  }
  if (kk == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        s_acc[warp][i * D + c * VEC + e] = acc[i][e];
      if (c == 0) {
        s_m[warp][i] = m[i];
        s_l[warp][i] = l[i];
      }
    }
  }
  __syncthreads();

  const bool direct = s_first == s_last;
  const int stride = G * D + 2 * G;      // one split's record in ws
  float* rec = direct ? nullptr
                      : ws + (head * gridDim.x + split) * (long long)stride;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int i = idx / D;
    float mx = s_m[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][i]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w][i] - mx);
      sum = fmaf(s_l[w][i], f, sum);
      a = fmaf(s_acc[w][idx], f, a);
    }
    if (direct) {
      og[idx] = repro::from_f32<T>(a / fmaxf(sum, 1e-30f));
    } else {
      rec[idx] = a;
      if (idx % D == 0) {
        rec[G * D + i] = mx;
        rec[G * D + G + i] = sum;
      }
    }
  }
  if (direct) return;

  __threadfence();                       // the record, before the ticket
  __syncthreads();
  if (tid == 0)
    s_is_last = atomicAdd(counters + head, 1) == s_last - s_first;
  __syncthreads();
  if (!s_is_last) return;
  __threadfence();
  const float* recs = ws + head * gridDim.x * (long long)stride;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int i = idx / D;
    float mx = kNegInf;
    for (int sp = s_first; sp <= s_last; ++sp)
      mx = fmaxf(mx, __ldcg(recs + sp * stride + G * D + i));
    float sum = 0.f, a = 0.f;
    for (int sp = s_first; sp <= s_last; ++sp) {
      const float* r = recs + sp * stride;
      const float f = expf(__ldcg(r + G * D + i) - mx);
      sum = fmaf(__ldcg(r + G * D + G + i), f, sum);
      a = fmaf(__ldcg(r + idx), f, a);
    }
    og[idx] = repro::from_f32<T>(a / fmaxf(sum, 1e-30f));
  }
  if (tid == 0) counters[head] = 0;      // ready for the next call
}

template <typename T, int D, int G>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* o, float* ws, int* counters, int b,
           int hkv, int n_pages, int btok, int nb, int pps, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid((nb + pps - 1) / pps, hkv, b);
  paged_split<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(o), ws,
      counters, hkv, n_pages, btok, nb, pps, window, scale);
  return (int)cudaGetLastError();
}

#define REPRO_PAGED_ARGS                                                  \
  q, kp, vp, tables, lengths, o, ws, counters, b, hkv, n_pages, btok, nb, \
      pps, window, scale, st

template <typename T, int D>
int dispatch_g(int g, const void* q, const void* kp, const void* vp,
               const int* tables, const int* lengths, void* o, float* ws,
               int* counters, int b, int hkv, int n_pages, int btok, int nb,
               int pps, int window, float scale, cudaStream_t st) {
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
               const int* tables, const int* lengths, void* o, float* ws,
               int* counters, int b, int hkv, int n_pages, int btok, int nb,
               int pps, int window, float scale, cudaStream_t st) {
  switch (d) {
    case 16: return dispatch_g<T, 16>(g, REPRO_PAGED_ARGS);
    case 32: return dispatch_g<T, 32>(g, REPRO_PAGED_ARGS);
    case 64: return dispatch_g<T, 64>(g, REPRO_PAGED_ARGS);
    case 128: return dispatch_g<T, 128>(g, REPRO_PAGED_ARGS);
    default: return repro::kUnsupported;
  }
}

}  // namespace

// C entry point (ctypes).  q and the pools must be contiguous and 16-byte
// aligned; tables and lengths int32.  ws: fp32 workspace of
// b * hkv * ceil(nb / pps) * (g * d + 2 g) floats (may be null when
// pps >= nb: every row then fits one split); counters: b * hkv int32, zero
// between calls (the kernel leaves them so).  Returns 0 on success, the
// cudaError_t of a refused launch, or -1 for a head_dim / group size /
// dtype no instance takes.
extern "C" int repro_paged_attention_decode(
    const void* q, const void* kp, const void* vp, const int* tables,
    const int* lengths, void* o, void* ws_, void* counters_, int b, int hq,
    int hkv, int n_pages, int btok, int nb, int d, int pps, int window,
    float scale, int dtype, void* stream) {
  if (btok < 1 || nb < 1 || pps < 1 || hkv < 1 || hq % hkv != 0 ||
      (ws_ == nullptr && pps < nb))
    return repro::kUnsupported;
  const int g = hq / hkv;
  float* ws = static_cast<float*>(ws_);
  int* counters = static_cast<int*>(counters_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch_d<float>(d, g, REPRO_PAGED_ARGS);
  if (dtype == repro::kBF16)
    return dispatch_d<__nv_bfloat16>(d, g, REPRO_PAGED_ARGS);
  return repro::kUnsupported;
}
