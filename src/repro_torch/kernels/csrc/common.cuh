// Helpers shared by the port's kernels: dtype conversion to
// and from fp32, and warp reductions.  Every kernel computes in fp32 and
// takes fp32 or bf16 tensors (dtype code 0 = fp32, 1 = bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;   // the reference kernels' NEG_INF
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kUnsupported = -1;    // returned for shapes no instance takes
constexpr int kTensorMapRefused = -2;   // the driver refused a TMA descriptor

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro

// Message for a non-zero return code of a kernel's C entry point.  Each
// kernel is its own shared library, so each carries its own copy.
extern "C" const char* repro_error_string(int code) {
  if (code == repro::kUnsupported)
    return "shape or dtype not supported by the kernel";
  if (code == repro::kTensorMapRefused)
    return "cuTensorMapEncodeTiled refused an operand's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
