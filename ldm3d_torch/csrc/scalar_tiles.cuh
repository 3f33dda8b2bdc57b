// Scalar building blocks shared by the attention kernels' plain route for
// head_dim > 256 (flash_fwd.cu, flash_bwd.cu): fp32 from and to either
// input dtype, and the copy of a tile of one (batch, head) slice into an
// fp32 shared-memory tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ldm3d {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [row0, row0 + ROWS) and columns [col0, col0 + COLS) of a slice with
// unit column stride, by the NT threads of a block, as fp32 into a ROWS x
// (COLS + 1) tile (the extra column keeps threads that read one column of
// 16 or 32 rows on different banks); zeros past `valid` rows and past d.
template <int ROWS, int COLS, int NT, typename T>
__device__ __forceinline__ void load_chunk(float (*dst)[COLS + 1], const T* __restrict__ src,
                                           int64_t row_stride, int row0, int valid, int col0,
                                           int d) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
    const int r = i / COLS;
    const int c = i % COLS;
    const int t = row0 + r;
    dst[r][c] = t < valid && col0 + c < d ? to_float(src[(int64_t)t * row_stride + col0 + c]) : 0.f;
  }
}

}  // namespace ldm3d
