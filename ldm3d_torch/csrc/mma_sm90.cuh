// Warp-level tensor-core building blocks for sm_90a, shared by the port's
// hand-written kernels: cp.async copies into shared memory (with zero-fill),
// ldmatrix fragment loads, the bf16 m16n8k16 and the tf32 m16n8k8 mma.sync
// with fp32 accumulators, the packing of fp32 accumulators into bf16
// operands, the split of an fp32 value into two tf32 parts and the 3xTF32
// product of a group of n-tiles.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 * g + t, g the
// group of four lanes, t the lane within it):
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, k-major), two registers: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C (16 x 8, fp32), four floats: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// The C layout of two neighbouring n-tiles is the A layout of one k-step, so
// a product's accumulators become the next product's A operand in registers.
//
// Fragment layouts of mma.sync.m16n8k8.row.col with .tf32 operands (one
// tf32 value in each b32 register):
//   A (16 x 8): a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]   a3 = A[g+8][t+4]
//   B (8 x 8):  b0 = B[t][g]   b1 = B[t+4][g]
//   C (16 x 8): as above, c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// Here the C layout is not the A layout: C holds columns 2t and 2t+1 where A
// wants t and t+4. A kernel that feeds C back as A keeps the registers where
// they are (a0, a1, a2, a3 = c0, c2, c1, c3), so that its k index t stands for
// column 2t of C and t+4 for 2t+1, and loads B's rows in the same order.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ldm3d {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `valid` false
// writes 16 zero bytes and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, asynchronously through L1 (for fp32 rows with no 16-byte
// alignment); `valid` false writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives each lane's part of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// As ldmatrix_x4, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b for one m16n8k16 tile, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16 and packed: `lo` in the low half,
// the lower column index of an A fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as two packed bf16 pairs whose sum carries each to about 2^-16
// of itself: `hi` rounded to nearest, `lo` the remainder x - hi (exact in
// fp32) rounded to nearest. An mma with `hi` and one with `lo` on the same B
// operand give the product of the fp32 values to that precision.
__device__ __forceinline__ void pack_bf16_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// c += a * b for one m16n8k8 tile, tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 value as two tf32 values whose sum carries it to about 2^-21 of
// itself: hi rounded to nearest (ties away from zero, as cvt.rna.tf32.f32
// for finite x), lo the remainder x - hi (exact in fp32) truncated to tf32.
// Three mma.sync, lo*hi + hi*lo + hi*hi, give the product of two fp32
// values to about 2^-20 of it (the lo*lo term is dropped): "3xTF32".
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// An A fragment's four fp32 values, given in register order a0..a3, split
// into their tf32 hi and lo parts.
__device__ __forceinline__ void split_tf32_a(float a0, float a1, float a2, float a3,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// c[j] += a * b[j] for G neighbouring n-tiles in 3xTF32. The three mma of a
// product go to one accumulator, each waiting for the one before; so the G
// lo*hi products go first, then the G hi*lo, then the G hi*hi.
template <int G>
__device__ __forceinline__ void mma_tf32x3(float (*c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[G][2],
                                           const uint32_t (&bl)[G][2]) {
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c[j], ah, bh[j][0], bh[j][1]);
}

// mma_tf32x3 for two products at once, G n-tiles each: the 2G lo*hi
// first, then the hi*lo, then the hi*hi, so that 2G independent mma stand
// between two on one accumulator.
template <int G>
__device__ __forceinline__ void mma_tf32x3_2(
    float (*c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], const uint32_t (&bh)[G][2],
    const uint32_t (&bl)[G][2], float (*c2)[4], const uint32_t (&ah2)[4], const uint32_t (&al2)[4],
    const uint32_t (&bh2)[G][2], const uint32_t (&bl2)[G][2]) {
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c2[j], al2, bh2[j][0], bh2[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c2[j], ah2, bl2[j][0], bl2[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32_1688(c2[j], ah2, bh2[j][0], bh2[j][1]);
}

// Start the copy of rows [row0, row0 + ROWS) of one (batch, head) slice of
// fp32 rows into a tile of pitch LD floats, by the NT threads of the block:
// 16-byte pieces when `vec16` (base and row stride on 16 bytes), else 4-byte
// ones; pieces of rows past `valid` are zero-filled. Columns past d are
// never written.
template <int ROWS, int LD, int DMAX, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              int64_t row_stride, int row0, int valid, int d,
                                              bool vec16) {
  if (vec16) {
    constexpr int CH = DMAX / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH;
      const int c = i % CH;
      if (c * 4 >= d) continue;
      const int t = row0 + r;
      const bool ok = t < valid;
      cp_async_16(smem_u32(dst + r * LD + c * 4), ok ? src + (int64_t)t * row_stride + c * 4 : src,
                  ok);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * DMAX; i += NT) {
      const int r = i / DMAX;
      const int c = i % DMAX;
      if (c >= d) continue;
      const int t = row0 + r;
      const bool ok = t < valid;
      cp_async_4(smem_u32(dst + r * LD + c), ok ? src + (int64_t)t * row_stride + c : src, ok);
    }
  }
}

}  // namespace ldm3d
