// Implicit-GEMM 3x3x3 convolution for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel _kernel of ldm3d_tpu/ops/conv3d.py (line 58,
// launched at :227 by conv3d_igemm at :192): a SAME, stride-1 3x3x3
// convolution of x (B, D, H, W, C), NDHWC, with w (3, 3, 3, C, Cout), DHWIO,
// C <= 64, accumulated in fp32 and stored in x's type (fp32 or bf16).
//
// As a GEMM: M = B*D*H*W output voxels, N = Cout, K = 27*C. What bounds it on
// the H100: the operations (2*M*N*K flops, 1.57e12 at (8, 96, 96, 96, 64))
// over the tensor cores' rate, far above the bytes (x, w and y once). This
// first version runs scalar fp32 FMA on the CUDA cores; tensor cores
// (mma.sync, then wgmma with TMA) are a later change.
//
// Design. The TPU kernel kept a rolling window of three padded planes in
// VMEM, stored the input in a paired-row layout for its 128 lanes, and
// patched up input row 0; none of that carries over. Here a block owns 64
// consecutive voxels of one (b, d) output plane and 64 output channels. For
// each of the 27 taps it stages the 64 shifted input rows (C channels each,
// zeros past every border: the d, h and w halos are index checks) and the
// tap's C x 64 weight slice in shared memory as fp32 (2 x 64 x 64 x 4 B =
// 32 KB at C = 64), then each of its 256 threads adds 4 voxels x 4 output
// channels over the tap's C inputs into fp32 registers. No im2col buffer in
// device memory; every block's sums run in one fixed order, so the result is
// the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output voxels per block (consecutive in one plane)
constexpr int TN = 64;        // output channels per block
constexpr int MAXC = 64;      // input channels the kernel takes
constexpr int NTHREADS = 256; // 16 x 16 threads, each 4 voxels x 4 channels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grid (ceil(H*W / TM), B*D, ceil(Cout / TN)), block NTHREADS.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) conv3d_igemm_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int D, int H, int W,
    int C, int Cout) {
  __shared__ float xs[TM][MAXC + 1];  // +1: rows of one column fall in distinct banks
  __shared__ float ws[MAXC][TN];

  const int HW = H * W;
  const int m0 = blockIdx.x * TM;
  const int bd = blockIdx.y;  // b * D + d
  const int b = bd / D;
  const int d = bd - b * D;
  const int n0 = blockIdx.z * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels n0 + tx + 16 j
  const int ty = tid / 16;  // voxels m0 + ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int pd = d + kd - 1;
    // stage the tap's shifted input rows: element (m, c), c fastest, so a
    // warp reads neighbouring channels of one voxel
    for (int e = tid; e < TM * C; e += NTHREADS) {
      const int m = e / C;
      const int c = e - m * C;
      const int vox = m0 + m;
      float v = 0.f;
      if (vox < HW && pd >= 0 && pd < D) {
        const int h = vox / W;
        const int ph = h + kh - 1;
        const int pw = vox - h * W + kw - 1;
        if (ph >= 0 && ph < H && pw >= 0 && pw < W)
          v = to_float(x[((((int64_t)b * D + pd) * H + ph) * W + pw) * C + c]);
      }
      xs[m][c] = v;
    }
    // stage the tap's weight slice (C, TN): element (c, n), n fastest
    const T* wt = w + (int64_t)tap * C * Cout;
    for (int e = tid; e < C * TN; e += NTHREADS) {
      const int c = e / TN;
      const int n = e - c * TN;
      ws[c][n] = (n0 + n < Cout) ? to_float(wt[(int64_t)c * Cout + n0 + n]) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < C; ++c) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = ws[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int vox = m0 + ty + 16 * i;
    if (vox >= HW) continue;
    T* yrow = y + ((int64_t)bd * HW + vox) * Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) store(yrow + n, acc[i][j]);
    }
  }
}

}  // namespace

// x: contiguous (B, D, H, W, C); w: contiguous (3, 3, 3, C, Cout); y:
// contiguous (B, D, H, W, Cout); all three of one type, fp32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1). 1 <= C <= 64. Runs on `stream`; returns the launch's
// cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_conv3d_igemm(const void* x, const void* w, void* y, int is_bf16, int B,
                                  int D, int H, int W, int C, int Cout, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || C > MAXC || Cout <= 0 ||
      (int64_t)B * D > 65535 || (Cout + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + TM - 1) / TM, B * D, (Cout + TN - 1) / TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    conv3d_igemm_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), D, H, W, C, Cout);
  else
    conv3d_igemm_kernel<float><<<grid, NTHREADS, 0, s>>>(static_cast<const float*>(x),
                                                         static_cast<const float*>(w),
                                                         static_cast<float*>(y), D, H, W, C,
                                                         Cout);
  return (int)cudaGetLastError();
}
