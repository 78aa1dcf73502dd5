// Tensor-core and async-copy primitives for Hopper (sm_90a), as inline PTX:
// the bf16 m16n8k16 `mma.sync` with fp32 accumulators, `ldmatrix` (plain
// and transposed) to load its fragments from shared memory, and the
// `cp.async` ring that streams 16-byte chunks from device memory into
// shared memory without passing through registers.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, "col")       b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C/D (16 x 8, fp32)      c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// Two adjacent n8 accumulator tiles, packed to bf16 pairs, are exactly the
// A fragment of one k16 step (`acc_to_a`: flash attention's P reused for
// P V, and the backward's P and dS for dV, dK and dQ).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy, device -> shared memory.  Bytes past `src_bytes`
// (0 or 16 here) are written as zeros, so a chunk outside the tensor is
// masked with no branch; `src` must still be a valid address.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4-byte async copy (one fp32), device -> shared memory; zero-filled
// when `src_bytes` is 0
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives element (l / 4, 2 (l % 4) ..+1) of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* src) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(src)));
}

// the same, transposed: lane l receives element (2 (l % 4) ..+1, l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* src) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(src)));
}

// d += a b: m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as a bf16x2 register, `lo` in the low half (the lower
// k or column index of a fragment pair), each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one k16 step from two adjacent n8 accumulator tiles
// (columns 0-7 in `lo`, 8-15 in `hi`) of an m16n8 product, each value
// rounded to bf16: the C layout of the pair is the A layout of the step
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16x2(lo[0], lo[1]);
  a[1] = pack_bf16x2(lo[2], lo[3]);
  a[2] = pack_bf16x2(hi[0], hi[1]);
  a[3] = pack_bf16x2(hi[2], hi[3]);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a shared-memory
// tile of `row_chunks` chunks per row (row_chunks a multiple of 8), the
// chunk index XOR-swizzled by the row's low three bits: the eight rows
// one ldmatrix phase reads at one column land in eight distinct bank
// groups, and cp.async's row-contiguous writes stay 16-byte aligned.
__device__ __forceinline__ int swz(int row, int chunk, int row_chunks) {
  return (row * row_chunks + (chunk ^ (row & 7))) * 16;
}

// The part of an ldmatrix.x4 address that depends on the lane: its row in
// a 16-row group and the XOR key of its chunk.  `swz_frag` adds the part
// known at compile time, so a fully unrolled fragment loop needs no
// address register per fragment.
struct FragLane {
  int row;                               // row within the 16-row group
  int key;                               // the lane's chunk bit ^ (row & 7)
};

// lane l reads row l % 16, chunk pair member l / 16: A fragments, and B
// fragments of a (k, n) row-major tile through ldmatrix.trans
__device__ __forceinline__ FragLane frag_lane_a(int lane) {
  return {lane & 15, (lane >> 4) ^ (lane & 7)};
}

// lane l reads row l % 8 + 8 (l / 16), chunk pair member (l / 8) % 2: B
// fragments of an (n, k) row-major tile through plain ldmatrix
__device__ __forceinline__ FragLane frag_lane_b(int lane) {
  return {(lane & 7) + ((lane >> 4) << 3), ((lane >> 3) & 1) ^ (lane & 7)};
}

// == swz(r0 + f.row, c0 + the lane's chunk bit, row_chunks) for r0 a
// multiple of 8 and c0 even
__device__ __forceinline__ int swz_frag(FragLane f, int r0, int c0,
                                        int row_chunks) {
  return ((r0 + f.row) * row_chunks + (c0 & ~7) + ((c0 & 7) ^ f.key)) * 16;
}

}  // namespace repro
