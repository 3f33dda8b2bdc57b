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
// over 3.35 TB/s. At batch 1 the UNet's volumes are small (125 to 1000
// voxels of up to 1024 channels, under 1 MB): there a call costs what a
// launch costs.
//
// The TPU streamed the voxel axis over a sequential grid axis into a VMEM
// accumulator; Hopper blocks run in parallel, so the voxel axis is split into
// chunks, each block (channel group, chunk, batch) sums its chunk in fp32, and
// the partials of a (batch, channel) are added in a fixed order: no atomics
// on the sums, the same sums in the same order on every run, and enough
// blocks even at batch 1. x is read in the activations' channels_last_3d
// memory, (B, V, C) with unit channel stride.
//
// * gn_sums (B4): one launch a call, gn_sums_onepass<T, VEC>.
//   - Loads: where x's base, voxel and batch strides sit on 16 bytes and VEC
//     divides C, each thread reads VEC = 16 bytes of neighbouring channels
//     (4 fp32 or 8 bf16), and the 8 threads of a voxel row cover 8 * VEC
//     channels, one 128-byte line; otherwise VEC = 1, one element a thread,
//     32 threads a row. The block is CT x (256 / CT) threads, CT a power of
//     two up to 32 (ldm3d_torch/ops/groupnorm.py gn_sums_plan picks it):
//     few channels a block and many voxel rows, so that a small volume at
//     batch 1 still spreads over many blocks with few loads a thread.
//   - Combine, "last block combines": each block reduces its voxel rows in
//     shared memory and writes fp32 partials, then __threadfence() and one
//     ticket from the arrival counter of its (batch, channel group); the
//     block that takes the last ticket adds the partials in a fixed order
//     (256 / (CT * VEC) threads a channel, each over every so many splits,
//     then their sums), writes S1 and S2, and sets the counter back to 0.
//     With one chunk a block writes S1 and S2 itself. The partials and the
//     counters live in buffers per device that the wrapper keeps (the
//     counters zeroed once); they assume that the calls that share them run
//     in order, as calls on one stream do.
//   - Combine, cluster: where up to 8 chunks do (a small volume), the
//     blocks of a channel group form one thread-block cluster instead, and
//     its first block adds the others' sums from their shared memory in
//     chunk order: no global round trip, no fence and no counter. On the
//     H100 it was 0.5 to 0.7 us a call faster than the last-block combine at
//     the same chunks (PERF.md), and the grid plan takes it where it can.
// * gn_bwd_sums (B5): two launches a call. partial_sums writes each chunk's
//   fp32 partials (a block of 32 x 8 threads takes 32 neighbouring channels
//   over 8 voxel rows, then reduces its 8 rows in shared memory) and combine
//   adds them in a fixed order. x's voxel and batch strides, and all three of
//   dy's, are arguments, so dy may have another layout than x.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CW = 32;   // channels per block of the split pass
constexpr int VR = 8;    // voxel rows per block of the split pass
constexpr int NT = 256;  // threads per block of the combine pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct View {
  int64_t sb, sv, sc;
};

// The two running sums of one element of the backward: dy and dy * x-hat.
template <typename T>
struct Terms {
  const T* x;
  const T* dy;
  const float* mean;
  const float* inv;
  View xv, dv;
  int C;

  __device__ __forceinline__ void add(int b, int v, int c, float& a1, float& a2) const {
    const float xe = to_float(x[b * xv.sb + (int64_t)v * xv.sv + c * xv.sc]);
    const float g = to_float(dy[b * dv.sb + (int64_t)v * dv.sv + c * dv.sc]);
    const float xh = (xe - mean[b * C + c]) * inv[b * C + c];
    a1 += g;
    a2 = fmaf(g, xh, a2);
  }
};

// grid (ceil(C / CW), nsplit, B), block (CW, VR); partials (B, nsplit, C).
template <typename T>
__global__ void __launch_bounds__(CW * VR) partial_sums(
    Terms<T> terms, float* __restrict__ p1, float* __restrict__ p2, int V, int chunk) {
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

template <typename T>
cudaError_t run(const Terms<T>& terms, float* s1, float* s2, float* scratch, int B, int V,
                int C, int nsplit, cudaStream_t stream) {
  const int chunk = (V + nsplit - 1) / nsplit;
  float* p1 = scratch;
  float* p2 = scratch + (int64_t)B * nsplit * C;
  const dim3 grid((C + CW - 1) / CW, nsplit, B);
  partial_sums<T><<<grid, dim3(CW, VR), 0, stream>>>(terms, p1, p2, V, chunk);
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

// ---------------------------------------------------------------------------
// B4: the forward sums in one launch

constexpr int GN_NT = 256;  // threads per block of gn_sums_onepass
constexpr int GN_WARPS = GN_NT / 32;
constexpr int GN_MAX_CW = 64;  // channels a block: 8 lanes of 8 bf16, or 32 of one
constexpr int GN_MAX_CLUSTER = 8;  // blocks in a cluster (the portable limit)

// VEC neighbouring elements as fp32: one 16-byte load where VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "16 bytes of fp32");
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    static_assert(VEC == 8, "16 bytes of bf16");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// Grid (ceil(C / (ct * VEC)), nsplit, B), GN_NT threads as ct channel lanes
// x (GN_NT / ct) voxel rows. Block (group, split, b) sums channels
// [group * ct * VEC, + ct * VEC) over voxels [split * chunk, + chunk) of
// batch b; thread (tx, ty) takes channels tx * VEC .. + VEC - 1 of the group
// at voxels ty, ty + GN_NT / ct, ... of the chunk. The block adds its rows
// in a fixed order: within a warp by shuffles, then the warps' sums in order.
// out: S1 (B, C), S2 (B, C); partials: for the last-block combine P1, P2
// (B, nsplit, C); all fp32; counters: one per (b, group), 0 between calls. With CLUSTER the nsplit blocks of a (group, b) form one thread-block
// cluster, and its first block adds the others' sums from their shared
// memory, in split order.
template <typename T, int VEC, bool CLUSTER>
__global__ void __launch_bounds__(GN_NT) gn_sums_onepass(
    const T* __restrict__ x, int64_t sb, int64_t sv, float* __restrict__ out,
    float* __restrict__ partials, unsigned* __restrict__ counters, int V, int C, int ct,
    int chunk) {
  __shared__ float red[2][GN_WARPS * GN_MAX_CW];
  __shared__ float part[2][GN_MAX_CW];
  __shared__ bool last;
  const int cw = ct * VEC;  // channels of the group
  const int rows = GN_NT / ct;
  const int tx = threadIdx.x % ct;
  const int ty = threadIdx.x / ct;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int group = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int b = blockIdx.z;
  const int c0 = group * cw + tx * VEC;
  const int v0 = split * chunk;
  const int v1 = min(V, v0 + chunk);

  float a1[VEC], a2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) a1[e] = a2[e] = 0.f;
  if (c0 < C) {
    const T* xb = x + b * sb + c0;
#pragma unroll 4
    for (int v = v0 + ty; v < v1; v += rows) {
      float xe[VEC];
      load_vec<T, VEC>(xb + (int64_t)v * sv, xe);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a1[e] += xe[e];
        a2[e] = fmaf(xe[e], xe[e], a2[e]);
      }
    }
  }
  // the warp's 32 / ct rows, then lanes < ct keep the warp's sum
  for (int off = ct; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a1[e] += __shfl_xor_sync(0xffffffffu, a1[e], off);
      a2[e] += __shfl_xor_sync(0xffffffffu, a2[e], off);
    }
  if (lane < ct)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[0][warp * cw + tx * VEC + e] = a1[e];
      red[1][warp * cw + tx * VEC + e] = a2[e];
    }
  __syncthreads();

  // thread i < cw adds the warps' sums of channel group * cw + i in order
  const int i = threadIdx.x;
  const int c = group * cw + i;
  const int64_t BC = (int64_t)gridDim.z * C;
  float s1 = 0.f, s2 = 0.f;
  if (i < cw) {
    for (int w = 0; w < GN_WARPS; ++w) {
      s1 += red[0][w * cw + i];
      s2 += red[1][w * cw + i];
    }
  }

  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    if (i < cw) {
      part[0][i] = s1;
      part[1][i] = s2;
    }
    cluster.sync();  // every block's sums are in its shared memory
    if (cluster.block_rank() == 0 && i < cw && c < C) {
      float t1 = 0.f, t2 = 0.f;
      for (int s = 0; s < nsplit; ++s) {
        const float* p = cluster.map_shared_rank(&part[0][0], s);
        t1 += p[i];
        t2 += p[GN_MAX_CW + i];
      }
      out[(int64_t)b * C + c] = t1;
      out[BC + (int64_t)b * C + c] = t2;
    }
    cluster.sync();  // the first block has read the others' shared memory
    return;
  } else {
    if (nsplit == 1) {
      if (i < cw && c < C) {
        out[(int64_t)b * C + c] = s1;
        out[BC + (int64_t)b * C + c] = s2;
      }
      return;
    }
    if (i < cw && c < C) {
      const int64_t o = ((int64_t)b * nsplit + split) * C + c;
      partials[o] = s1;
      partials[(int64_t)nsplit * BC + o] = s2;
    }

    // the last block of (b, group) to arrive adds the partials: GN_NT / cw
    // threads a channel, thread r taking splits r, r + GN_NT / cw, ... in
    // order, then their sums in order of r
    __threadfence();
    __syncthreads();
    unsigned* counter = counters + (int64_t)b * gridDim.x + group;
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)nsplit - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int ways = GN_NT / cw;
    const int r = threadIdx.x / cw;
    const int cr = group * cw + threadIdx.x % cw;
    float p1s = 0.f, p2s = 0.f;
    if (cr < C) {
      const float* p1 = partials + (int64_t)b * nsplit * C + cr;
      const float* p2 = p1 + (int64_t)nsplit * BC;
#pragma unroll 4
      for (int s = r; s < nsplit; s += ways) {
        p1s += __ldcg(p1 + (int64_t)s * C);
        p2s += __ldcg(p2 + (int64_t)s * C);
      }
    }
    red[0][threadIdx.x] = p1s;  // every thread read its entries of red before the ticket
    red[1][threadIdx.x] = p2s;
    __syncthreads();
    if (r == 0 && cr < C) {
      float t1 = 0.f, t2 = 0.f;
      for (int w = 0; w < ways; ++w) {
        t1 += red[0][w * cw + threadIdx.x];
        t2 += red[1][w * cw + threadIdx.x];
      }
      out[(int64_t)b * C + cr] = t1;
      out[BC + (int64_t)b * C + cr] = t2;
    }
    if (threadIdx.x == 0) *counter = 0u;
  }
}

template <typename T, int VEC>
cudaError_t launch_onepass(const void* x, int64_t sb, int64_t sv, float* out, float* partials,
                           unsigned* counters, int B, int V, int C, int ct, int nsplit, int chunk,
                           bool cluster, cudaStream_t stream) {
  const dim3 grid((C + ct * VEC - 1) / (ct * VEC), nsplit, B);
  const T* xp = static_cast<const T*>(x);
  if (!cluster) {
    gn_sums_onepass<T, VEC, false><<<grid, GN_NT, 0, stream>>>(xp, sb, sv, out, partials,
                                                               counters, V, C, ct, chunk);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GN_NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gn_sums_onepass<T, VEC, true>, xp, sb, sv, out, partials,
                            counters, V, C, ct, chunk);
}

}  // namespace

// x: (B, V, C) with unit channel stride, read through its batch and voxel
// element strides sb, sv; with vec > 1 (4 for fp32, 8 for bf16) x, sb and sv
// sit on 16 bytes and vec divides C. ct: channel lanes of a block, a power of
// two with ct * vec <= 64. The voxels split into nsplit chunks of `chunk`,
// each chunk non-empty. With cluster != 0 the nsplit (at most 8) blocks of a
// channel group form a cluster that adds its sums in shared memory; else the
// last block to finish adds the partials. out: 2 * B * C fp32 (S1 then S2).
// partials: for the last-block combine with nsplit > 1, 2 * B * nsplit * C
// fp32 of scratch. counters: B * ceil(C / (ct * vec)) zeros, which the call
// leaves at zero. Calls that share the partials and counters run in order.
// One launch; returns its cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_gn_sums(const void* x, void* out, void* partials, void* counters, int is_bf16,
                             int B, int V, int C, int64_t sb, int64_t sv, int vec, int ct,
                             int nsplit, int chunk, int cluster, void* stream) {
  const bool ct_ok = ct >= 1 && ct <= 32 && (ct & (ct - 1)) == 0 && ct * vec <= GN_MAX_CW;
  if (B <= 0 || V <= 0 || C <= 0 || B > 65535 || nsplit <= 0 || nsplit > 65535 || !ct_ok ||
      chunk <= 0 || (int64_t)(nsplit - 1) * chunk >= V || (int64_t)nsplit * chunk < V ||
      (cluster && nsplit > GN_MAX_CLUSTER) ||
      (vec != 1 && (vec != (is_bf16 ? 8 : 4) || C % vec != 0 || sb % vec != 0 ||
                    sv % vec != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool cl = cluster != 0;
  if (is_bf16) {
    if (vec == 8)
      return (int)launch_onepass<__nv_bfloat16, 8>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit,
                                                   chunk, cl, s);
    return (int)launch_onepass<__nv_bfloat16, 1>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit,
                                                 chunk, cl, s);
  }
  if (vec == 4)
    return (int)launch_onepass<float, 4>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit, chunk, cl, s);
  return (int)launch_onepass<float, 1>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit, chunk, cl, s);
}

// dy, x: (B, V, C) read through strides[0..2] = (sb, sv, sc) of x, whose sc
// must be 1 (channels minor), and strides[3..5] of dy, in elements; mean,
// inv: contiguous (B, C) fp32. s1, s2: contiguous (B, C) fp32. scratch:
// 2 * B * nsplit * C fp32. Runs the split pass and the combine pass on
// `stream`; returns the first failing launch's cudaError_t (0 on success);
// allocates nothing.
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
    Terms<__nv_bfloat16> t{static_cast<const __nv_bfloat16*>(x),
                                 static_cast<const __nv_bfloat16*>(dy), m, iv, xv, dv, C};
    return (int)run(t, o1, o2, sc, B, V, C, nsplit, s);
  }
  Terms<float> t{static_cast<const float*>(x), static_cast<const float*>(dy), m, iv, xv,
                       dv, C};
  return (int)run(t, o1, o2, sc, B, V, C, nsplit, s);
}
