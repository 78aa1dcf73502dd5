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
// (src/repro/models/rwkv.py:149-153).
//
// What bounds it on the H100: rwkv6-3b's fp32 prefill of 300 tokens reads
// r, k, v, logw (1, 300, 40, 64) and writes o and the 40 x 64 x 64 state,
// 16 MB, 4.8 us at 3.35 TB/s; its ~5 n^2 flops per token and head are
// 0.25 GFLOP, 3.7 us at the 67 TFLOP/s fp32 peak.  At batch 1 only 40
// blocks of 64 threads run, so the real limit is the serial chain of 300
// steps: each step's shared-memory reads, multiply-adds and barrier.
//
// Design: one block per (head, batch row), one thread per state column:
// thread j keeps S[:, j] in registers and owns v_t[j] and o_t[j].  At each
// step r_t, k_t and w_t = exp(logw_t) are staged in shared memory (each
// thread loads one element of each), double-buffered so that a step needs
// one barrier, and the next step's loads are issued before this step's
// arithmetic.  The dot product r_t . S[:, j] runs in four partial sums to
// shorten its dependency chain.  This is the serial form of the RWKV CUDA
// kernel, not the TPU's chunked form; it is exact against the per-token
// plain version up to the order of its sums.  Strides are arguments, so
// the model's (b, s, h, n) tensors are read without a transpose copy.
#include "common.cuh"

namespace {

struct Strides {
  long long b, s, h;                     // in elements; n is contiguous
};

template <typename T, int N>
__global__ void __launch_bounds__(N)
wkv_fwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ logw,
        const float* __restrict__ u, const float* __restrict__ s0,
        T* __restrict__ o, float* __restrict__ s_out, int heads, int seq,
        Strides rs, Strides ks, Strides vs, Strides ws, Strides os) {
  __shared__ float sr[2][N], sk[2][N], sw[2][N], su[N];
  const int ih = blockIdx.x, ib = blockIdx.y, j = threadIdx.x;
  const T* rb = r + ib * rs.b + ih * rs.h + j;
  const T* kb = k + ib * ks.b + ih * ks.h + j;
  const T* vb = v + ib * vs.b + ih * vs.h + j;
  const T* wb = logw + ib * ws.b + ih * ws.h + j;
  T* ob = o + ib * os.b + ih * os.h + j;
  const long long sbase = ((long long)ib * heads + ih) * N * N + j;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 != nullptr ? s0[sbase + i * N] : 0.f;
  su[j] = u[ih * N + j];
  float vj = 0.f;
  if (seq > 0) {
    sr[0][j] = repro::to_f32(rb[0]);
    sk[0][j] = repro::to_f32(kb[0]);
    sw[0][j] = expf(repro::to_f32(wb[0]));
    vj = repro::to_f32(vb[0]);
  }
  __syncthreads();

  for (int t = 0; t < seq; ++t) {
    const int cur = t & 1;
    // next step's loads, issued before this step's arithmetic
    float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
    if (t + 1 < seq) {
      rn = repro::to_f32(rb[(t + 1) * rs.s]);
      kn = repro::to_f32(kb[(t + 1) * ks.s]);
      wn = repro::to_f32(wb[(t + 1) * ws.s]);
      vn = repro::to_f32(vb[(t + 1) * vs.s]);
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float bonus = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float ri = sr[cur][i], ki = sk[cur][i];
      acc[i & 3] = fmaf(ri, S[i], acc[i & 3]);
      bonus = fmaf(ri * su[i], ki, bonus);
      S[i] = fmaf(sw[cur][i], S[i], ki * vj);
    }
    ob[t * os.s] = repro::from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]) +
                                      bonus * vj);
    // buffer cur ^ 1 was last read in step t - 1, before its barrier
    if (t + 1 < seq) {
      sr[cur ^ 1][j] = rn;
      sk[cur ^ 1][j] = kn;
      sw[cur ^ 1][j] = expf(wn);
    }
    vj = vn;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[sbase + i * N] = S[i];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, const float* s0, void* o, float* s_out, int b,
           int h, int seq, Strides rs, Strides ks, Strides vs, Strides ws,
           Strides os, cudaStream_t stream) {
  const dim3 grid(h, b);
  wkv_fwd<T, N><<<grid, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(logw), u, s0,
      static_cast<T*>(o), s_out, h, seq, rs, ks, vs, ws, os);
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
// (b, h, n, n) fp32 or null; o: (b, s, h, n) in the inputs' dtype; s_out:
// contiguous (b, h, n, n) fp32.  Returns 0 on success, the cudaError_t of a
// refused launch, or -1 for an n / dtype no instance takes.
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
