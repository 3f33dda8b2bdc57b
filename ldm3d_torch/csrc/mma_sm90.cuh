// Tensor-core building blocks for sm_90a, shared by the port's hand-written
// kernels: cp.async copies into shared memory (with zero-fill),
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
//
// Hopper's warpgroup products and copies (the second part of this file):
// mbarriers, TMA tensor loads (cp.async.bulk.tensor) that complete on an
// mbarrier, shared-memory matrix descriptors for 128-byte-swizzled tiles,
// and wgmma.mma_async. A warpgroup is 4 consecutive warps (128 threads,
// the first warp a multiple of 4); warp w of it owns rows 16w .. 16w + 15 of
// a 64-row tile. Its fp32 accumulator of m64nN holds, in thread lane = 4g + t
// of warp w, for each n-tile j < N / 8: d[4j], d[4j+1] = D[16w + g][8j + 2t,
// 8j + 2t + 1], d[4j+2], d[4j+3] = D[16w + g + 8][8j + 2t, 8j + 2t + 1]: per
// warp and n-tile the mma.sync m16n8 C layout. An A operand in registers is,
// per warp and k-step of 16, the mma.sync m16n8k16 A fragment; so the
// accumulators of two neighbouring n-tiles are the A registers of one k-step
// (c0 c1 | c2 c3 of n-tile 2kk, then of 2kk + 1), as with mma.sync.

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

// ---------------------------------------------------------------------------
// Hopper: mbarriers, TMA, wgmma

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` has completed (waiting a while in
// hardware first).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// about 4 s of clock (a barrier that can no longer complete) traps, so a
// fault in the pipeline ends the kernel with an error instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 33)) __trap();
}

// One box of a 4-D tensor map (a CUtensorMap in kernel parameter space,
// given by its generic address) into shared memory at `dst`, coordinates
// innermost first; completes `bytes` (the whole box, zero-filled past the
// tensor's bounds) on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_desc(const void* tmap) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(tmap)) : "memory");
}

// The wgmma descriptor of a tile in shared memory in the 128-byte swizzle
// (rows of 128 bytes, 16-byte pieces XOR-ed with row % 8, atoms of 8 rows on
// 1024 bytes). K-major (rows along M or N, k contiguous): lbo unused (1),
// sbo = 1024, the start address stepping 32 bytes a k-step inside the row.
// MN-major: lbo = bytes from one 64-element atom of M or N to the next, sbo =
// bytes from one 8-row group of k to the next.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads shared memory with.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait (their values change asynchronously).
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for one m64n64k16 tile of a warpgroup, bf16 in, fp32
// accumulators; A and B from shared memory by descriptor, both K-major.
// scale_d = 0 writes d = A B.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B for one m64n256k16 tile of a warpgroup, bf16 in, fp32
// accumulators; A from registers (each warp's 16 rows as the m16n8k16 A
// fragment), B from shared memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n256k16_rs_tnspb(float (&d)[128], const uint32_t (&a)[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


// As wgmma_m64n256k16_rs_tnspb, for an m64n64k16 tile.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tnspb(float (&d)[32], const uint32_t (&a)[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


// As wgmma_m64n256k16_rs_tnspb, for an m64n128k16 tile.
__device__ __forceinline__ void wgmma_m64n128k16_rs_tnspb(float (&d)[64], const uint32_t (&a)[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Barrier `id` (1 to 15; 0 is __syncthreads) among `count` threads, a
// multiple of 32: a warpgroup's own barrier.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace ldm3d
