// GroupNorm voxel sums for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas kernels of ldm3d_tpu/ops/groupnorm.py:
// _sums_kernel (line 70, launched at :92) and _bwd_sums_kernel (line 144,
// launched at :171). For x of shape (B, V, C) they give, per (batch, channel)
// and in fp32:
//   gn_sums:      S1 = sum_v x,   S2 = sum_v x^2               (forward statistics)
//   gn_bwd_sums:  S1 = sum_v dy,  S2 = sum_v dy * (x - mean) * inv   (backward)
// with x-hat formed on the fly, so the backward reads dy and x once each.
//
// What bounds it on the H100: one fp32 add (two for the squares) per element
// read, so the bound is the bytes, one read of x (B4) or of dy and x (B5)
// over 3.35 TB/s.
//
// Design. The TPU streamed the voxel axis over a sequential grid axis into a
// VMEM accumulator; Hopper blocks run in parallel, so the voxel axis is split
// into chunks, one block per (chunk, batch, channel group) writes fp32
// partial sums, and a second pass adds each (batch, channel)'s partials in a
// fixed order: no atomics, the same sums in the same order on every run, and
// enough blocks even at batch 1 and 256 channels. x is read in the
// activations' channels_last_3d memory, (B, V, C) with unit channel stride: a
// block of 32 x 8 threads takes 32 neighbouring channels (one warp reads 32
// neighbouring elements of one voxel) over 8 voxel rows, then reduces its 8
// rows in shared memory. x's voxel and batch strides, and all three of dy's,
// are arguments, so dy may have another layout than x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 32;   // channels per block of the split pass
constexpr int VR = 8;    // voxel rows per block of the split pass
constexpr int NT = 256;  // threads per block of the combine pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct View {
  int64_t sb, sv, sc;
};

// The two running sums of one element: (x, x^2) forward, (dy, dy * x-hat) backward.
template <typename T, bool BWD>
struct Terms {
  const T* x;
  const T* dy;
  const float* mean;
  const float* inv;
  View xv, dv;
  int C;

  __device__ __forceinline__ void add(int b, int v, int c, float& a1, float& a2) const {
    const float xe = to_float(x[b * xv.sb + (int64_t)v * xv.sv + c * xv.sc]);
    if (BWD) {
      const float g = to_float(dy[b * dv.sb + (int64_t)v * dv.sv + c * dv.sc]);
      const float xh = (xe - mean[b * C + c]) * inv[b * C + c];
      a1 += g;
      a2 = fmaf(g, xh, a2);
    } else {
      a1 += xe;
      a2 = fmaf(xe, xe, a2);
    }
  }
};

// grid (ceil(C / CW), nsplit, B), block (CW, VR); partials (B, nsplit, C).
template <typename T, bool BWD>
__global__ void __launch_bounds__(CW * VR) partial_sums(
    Terms<T, BWD> terms, float* __restrict__ p1, float* __restrict__ p2, int V, int chunk) {
  __shared__ float r1[VR][CW];
  __shared__ float r2[VR][CW];
  const int C = terms.C;
  const int c = blockIdx.x * CW + threadIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int v0 = split * chunk;
  const int v1 = min(V, v0 + chunk);
  float a1 = 0.f, a2 = 0.f;
  if (c < C)
    for (int v = v0 + threadIdx.y; v < v1; v += VR) terms.add(b, v, c, a1, a2);
  r1[threadIdx.y][threadIdx.x] = a1;
  r2[threadIdx.y][threadIdx.x] = a2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int r = 0; r < VR; ++r) {
      s1 += r1[r][threadIdx.x];
      s2 += r2[r][threadIdx.x];
    }
    const int64_t o = ((int64_t)b * gridDim.y + split) * C + c;
    p1[o] = s1;
    p2[o] = s2;
  }
}

// grid (ceil(C / NT), B): out[b, c] = sum over splits in order.
__global__ void __launch_bounds__(NT) combine(const float* __restrict__ p1,
                                              const float* __restrict__ p2,
                                              float* __restrict__ s1, float* __restrict__ s2,
                                              int nsplit, int C) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  float a1 = 0.f, a2 = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t o = ((int64_t)b * nsplit + s) * C + c;
    a1 += p1[o];
    a2 += p2[o];
  }
  s1[(int64_t)b * C + c] = a1;
  s2[(int64_t)b * C + c] = a2;
}

template <typename T, bool BWD>
cudaError_t run(const Terms<T, BWD>& terms, float* s1, float* s2, float* scratch, int B, int V,
                int C, int nsplit, cudaStream_t stream) {
  const int chunk = (V + nsplit - 1) / nsplit;
  float* p1 = scratch;
  float* p2 = scratch + (int64_t)B * nsplit * C;
  const dim3 grid((C + CW - 1) / CW, nsplit, B);
  partial_sums<T, BWD><<<grid, dim3(CW, VR), 0, stream>>>(terms, p1, p2, V, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine<<<dim3((C + NT - 1) / NT, B), NT, 0, stream>>>(p1, p2, s1, s2, nsplit, C);
  return cudaGetLastError();
}

// The sizes the grids take, and x channels minor.
bool bad_args(int B, int V, int C, int nsplit, const int64_t* x_strides) {
  return B <= 0 || V <= 0 || C <= 0 || nsplit <= 0 || nsplit > V || B > 65535 ||
         nsplit > 65535 || C > 65535 || x_strides[2] != 1;
}

}  // namespace

// x: (B, V, C) read through strides[0..2] = (sb, sv, sc) in elements; the
// sc must be 1 (channels minor). s1, s2: contiguous (B, C) fp32. scratch:
// 2 * B * nsplit * C fp32.
// Runs the split pass and the combine pass on `stream`; returns the first
// failing launch's cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_gn_sums(const void* x, void* s1, void* s2, void* scratch, int is_bf16, int B,
                             int V, int C, const int64_t* strides, int nsplit, void* stream) {
  if (bad_args(B, V, C, nsplit, strides)) return (int)cudaErrorInvalidValue;
  const View xv{strides[0], strides[1], strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    Terms<__nv_bfloat16, false> t{xp, nullptr, nullptr, nullptr, xv, xv, C};
    return (int)run(t, o1, o2, sc, B, V, C, nsplit, s);
  }
  const auto* xp = static_cast<const float*>(x);
  Terms<float, false> t{xp, nullptr, nullptr, nullptr, xv, xv, C};
  return (int)run(t, o1, o2, sc, B, V, C, nsplit, s);
}

// dy, x: (B, V, C), strides[0..2] of x and strides[3..5] of dy; mean, inv:
// contiguous (B, C) fp32. Otherwise as ldm3d_gn_sums.
extern "C" int ldm3d_gn_bwd_sums(const void* dy, const void* x, const void* mean, const void* inv,
                                 void* s1, void* s2, void* scratch, int is_bf16, int B, int V,
                                 int C, const int64_t* strides, int nsplit, void* stream) {
  if (bad_args(B, V, C, nsplit, strides)) return (int)cudaErrorInvalidValue;
  const View xv{strides[0], strides[1], strides[2]};
  const View dv{strides[3], strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  float* sc = static_cast<float*>(scratch);
  const auto* m = static_cast<const float*>(mean);
  const auto* iv = static_cast<const float*>(inv);
  if (is_bf16) {
    Terms<__nv_bfloat16, true> t{static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const __nv_bfloat16*>(dy), m, iv, xv, dv, C};
    return (int)run(t, o1, o2, sc, B, V, C, nsplit, s);
  }
  Terms<float, true> t{static_cast<const float*>(x), static_cast<const float*>(dy), m, iv, xv,
                       dv, C};
  return (int)run(t, o1, o2, sc, B, V, C, nsplit, s);
}
