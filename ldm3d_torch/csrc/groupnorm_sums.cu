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
// Both are one launch a call, gn_sums_onepass<T, VEC, CLUSTER> (B4) and
// gn_bwd_sums_onepass<T, VEC, CLUSTER> (B5), two kernels over one body,
// onepass(), that differ only in what a thread loads and adds (SumsTerms,
// BwdTerms); ldm3d_torch/ops/groupnorm.py gn_sums_plan and gn_bwd_sums_plan
// lay out their grids.
//   - Loads: where every operand's base, voxel and batch strides sit on 16
//     bytes, its channel stride is 1 and VEC divides C, each thread reads VEC
//     = 16 bytes of neighbouring channels of each operand (4 fp32 or 8 bf16),
//     and the 8 threads of a voxel row cover 8 * VEC channels, one 128-byte
//     line; otherwise VEC = 1, one element a thread, 32 threads a row (B5's
//     dy then takes any channel stride). The block is CT x (256 / CT)
//     threads, CT a power of two up to 32: few channels a block and many
//     voxel rows, so that a small volume at batch 1 still spreads over many
//     blocks. B5 keeps the VEC means and inverse deviations of its channels
//     in registers, loaded once a thread.
//   - Combine, "last block combines": each block reduces its voxel rows (by
//     warp shuffles, then the warps in order) and writes fp32 partials, then
//     __threadfence() and one ticket from the arrival counter of its (batch,
//     channel group); the block that takes the last ticket adds the partials
//     in a fixed order, writes S1 and S2, and sets the counter back to 0. Its
//     threads read 16 bytes (4 channels) of partials a load where VEC > 1,
//     up to 256 / 16 = 16 chunks at once, each thread several in flight. With
//     one chunk a block writes S1 and S2 itself. The partials and the
//     counters live in buffers per device that the wrapper keeps (the
//     counters zeroed once) and that B4 and B5 share; they assume that the
//     calls that share them run in order, as calls on one stream do.
//   - Combine, cluster: where up to 8 chunks do (a small volume), the
//     blocks of a channel group form one thread-block cluster instead, and
//     its first block adds the others' sums from their shared memory in
//     chunk order: no global round trip, no fence and no counter. The plans
//     take it where it measured faster on the H100 (PERF.md): B4 at up to 8
//     chunks, B5 only at a few voxel rows a thread (in bf16 at large volumes
//     a cluster of 2 to 8 blocks ran up to 1.7 times slower than the same
//     blocks without one).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GN_NT = 256;  // threads per block
constexpr int GN_WARPS = GN_NT / 32;
constexpr int GN_MAX_CW = 64;  // channels a block: 8 lanes of 8 bf16, or 32 of one
constexpr int GN_MAX_CLUSTER = 8;  // blocks in a cluster (the portable limit)
// shared sums: the warps' (GN_WARPS * GN_MAX_CW) or the last-block combine's
// (GN_NT threads of up to 4 channels)
constexpr int GN_RED = 4 * GN_NT;
// blocks an SM holds at least (the registers capped to fit): 6 keeps
// gn_sums_onepass at the 40 registers it had before its loads were
// unrolled, which the batch-20 grids of thousands of blocks need; 4 for
// gn_bwd_sums_onepass, which holds twice the loads (PERF.md)
constexpr int GN_SUMS_MIN_BLOCKS = 6;
constexpr int GN_BWD_MIN_BLOCKS = 4;
// voxel rows (or the combine's chunks) whose loads a thread issues before
// their adds: within those registers without a spill (4 spilled in bf16,
// PERF.md)
constexpr int GN_UNROLL = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC neighbouring elements as fp32: one 16-byte load where VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
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

// B4's terms of voxel v: x and x^2. p: x at (b, the thread's first channel).
template <typename T, int VEC>
struct SumsTerms {
  const T* p;
  int64_t sv;

  __device__ __forceinline__ void add(int v, float (&a1)[VEC], float (&a2)[VEC]) const {
    float xe[VEC];
    load_vec<T, VEC>(p + (int64_t)v * sv, xe);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a1[e] += xe[e];
      a2[e] = fmaf(xe[e], xe[e], a2[e]);
    }
  }
};

// B5's terms of voxel v: dy and dy * x-hat, with x-hat = (x - mean) * inv
// formed explicitly (not inv * (dy * x - mean * dy), which cancels where
// |mean| * inv is large). xp, dp: x and dy at (b, the thread's first
// channel); m, iv: its channels' mean and inv.
template <typename T, int VEC>
struct BwdTerms {
  const T* xp;
  const T* dp;
  int64_t xsv, dsv;
  float m[VEC], iv[VEC];

  __device__ __forceinline__ void add(int v, float (&a1)[VEC], float (&a2)[VEC]) const {
    float xe[VEC], g[VEC];
    load_vec<T, VEC>(xp + (int64_t)v * xsv, xe);
    load_vec<T, VEC>(dp + (int64_t)v * dsv, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      a1[e] += g[e];
      a2[e] = fmaf(g[e], (xe[e] - m[e]) * iv[e], a2[e]);
    }
  }
};

// Q partials of neighbouring channels, from L2 (other blocks wrote them)
template <int Q>
__device__ __forceinline__ void load_partial(const float* p, float (&out)[Q]) {
  if constexpr (Q == 1) {
    out[0] = __ldcg(p);
  } else {
    static_assert(Q == 4, "16 bytes of partials");
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

// The last block's sum of the nsplit partials of channels [group * cw, + cw)
// of batch b, in a fixed order. A thread takes Q neighbouring channels (Q = 4
// where cw and C are multiples of 4), tr = cw / Q threads cover a chunk's
// row and ways = GN_NT / tr rows run at once: thread row r adds chunks r,
// r + ways, r + 2 ways, ... in order (unrolled, so that the loads of several
// chunks are in flight), then the block adds the rows' sums in order of r.
template <int Q>
__device__ __forceinline__ void combine_partials(const float* __restrict__ partials,
                                                 float* __restrict__ out,
                                                 float (&red)[2][GN_RED], int b, int group,
                                                 int cw, int nsplit, int C, int64_t BC) {
  const int tr = cw / Q;
  const int ways = GN_NT / tr;
  const int r = threadIdx.x / tr;
  const int j = (threadIdx.x % tr) * Q;
  const int c = group * cw + j;
  float s1[Q], s2[Q];
#pragma unroll
  for (int e = 0; e < Q; ++e) s1[e] = s2[e] = 0.f;
  if (c < C) {
    const float* p1 = partials + (int64_t)b * nsplit * C + c;
    const float* p2 = p1 + (int64_t)nsplit * BC;
    const int n = (nsplit - r + ways - 1) / ways;
#pragma unroll GN_UNROLL
    for (int k = 0; k < n; ++k) {
      float u1[Q], u2[Q];
      load_partial<Q>(p1 + (int64_t)(r + k * ways) * C, u1);
      load_partial<Q>(p2 + (int64_t)(r + k * ways) * C, u2);
#pragma unroll
      for (int e = 0; e < Q; ++e) {
        s1[e] += u1[e];
        s2[e] += u2[e];
      }
    }
  }
  // every thread read its entries of red before the ticket
#pragma unroll
  for (int e = 0; e < Q; ++e) {
    red[0][r * cw + j + e] = s1[e];
    red[1][r * cw + j + e] = s2[e];
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < cw && group * cw + i < C) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < ways; ++w) {
      t1 += red[0][w * cw + i];
      t2 += red[1][w * cw + i];
    }
    out[(int64_t)b * C + group * cw + i] = t1;
    out[BC + (int64_t)b * C + group * cw + i] = t2;
  }
}

// The body of both kernels. Grid (ceil(C / (ct * VEC)), nsplit, B), GN_NT
// threads as ct channel lanes x (GN_NT / ct) voxel rows. Block (group,
// split, b) sums channels [group * ct * VEC, + ct * VEC) over voxels
// [split * chunk, + chunk) of batch b; thread (tx, ty) takes channels
// tx * VEC .. + VEC - 1 of the group (where ``active``: they start below C)
// at voxels ty, ty + GN_NT / ct, ... of the chunk, through ``terms``. The
// block adds its rows in a fixed order: within a warp by shuffles, then the
// warps' sums in order. out: S1 (B, C), S2 (B, C); partials: for the
// last-block combine P1, P2 (B, nsplit, C); all fp32; counters: one per
// (b, group), 0 between calls. With CLUSTER the nsplit blocks of a (group,
// b) form one thread-block cluster, and its first block adds the others'
// sums from their shared memory, in split order.
template <int VEC, bool CLUSTER, typename Terms>
__device__ __forceinline__ void onepass(const Terms& terms, bool active, float* __restrict__ out,
                                        float* __restrict__ partials,
                                        unsigned* __restrict__ counters, int V, int C, int ct,
                                        int chunk) {
  __shared__ float red[2][GN_RED];
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
  const int v0 = split * chunk;
  const int v1 = min(V, v0 + chunk);

  float a1[VEC], a2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) a1[e] = a2[e] = 0.f;
  if (active) {
    // a counted loop: unrolled, it issues GN_UNROLL rows' loads before their
    // adds (a loop on v < v1 branched after each row's loads)
    const int n = (v1 - v0 - ty + rows - 1) / rows;
#pragma unroll GN_UNROLL
    for (int k = 0; k < n; ++k) terms.add(v0 + ty + k * rows, a1, a2);
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
    // the last block of (b, group) to arrive adds the partials
    __threadfence();
    __syncthreads();
    unsigned* counter = counters + (int64_t)b * gridDim.x + group;
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)nsplit - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    combine_partials<(VEC > 1 ? 4 : 1)>(partials, out, red, b, group, cw, nsplit, C, BC);
    if (threadIdx.x == 0) *counter = 0u;
  }
}

// B4: x (B, V, C) with unit channel stride, batch and voxel strides sb, sv.
template <typename T, int VEC, bool CLUSTER>
__global__ void __launch_bounds__(GN_NT, GN_SUMS_MIN_BLOCKS) gn_sums_onepass(
    const T* __restrict__ x, int64_t sb, int64_t sv, float* __restrict__ out,
    float* __restrict__ partials, unsigned* __restrict__ counters, int V, int C, int ct,
    int chunk) {
  const int c0 = blockIdx.x * ct * VEC + (threadIdx.x % ct) * VEC;
  const SumsTerms<T, VEC> terms{x + blockIdx.z * sb + c0, sv};
  onepass<VEC, CLUSTER>(terms, c0 < C, out, partials, counters, V, C, ct, chunk);
}

// B5: x as B4's; dy (B, V, C) through its own three strides (unit channel
// stride where VEC > 1); mean, inv: contiguous (B, C) fp32.
template <typename T, int VEC, bool CLUSTER>
__global__ void __launch_bounds__(GN_NT, GN_BWD_MIN_BLOCKS) gn_bwd_sums_onepass(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ mean,
    const float* __restrict__ inv, int64_t xsb, int64_t xsv, int64_t dsb, int64_t dsv,
    int64_t dsc, float* __restrict__ out, float* __restrict__ partials,
    unsigned* __restrict__ counters, int V, int C, int ct, int chunk) {
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * ct * VEC + (threadIdx.x % ct) * VEC;
  const bool active = c0 < C;
  BwdTerms<T, VEC> terms;
  terms.xp = x + b * xsb + c0;
  terms.dp = dy + b * dsb + c0 * dsc;
  terms.xsv = xsv;
  terms.dsv = dsv;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    terms.m[e] = active ? mean[(int64_t)b * C + c0 + e] : 0.f;
    terms.iv[e] = active ? inv[(int64_t)b * C + c0 + e] : 0.f;
  }
  onepass<VEC, CLUSTER>(terms, active, out, partials, counters, V, C, ct, chunk);
}

// One launch of ``kernel`` on grid (groups, nsplit, B), as a cluster of the
// nsplit blocks of a channel group where ``cluster``.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, bool cluster, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GN_NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int VEC>
cudaError_t launch_sums(const void* x, int64_t sb, int64_t sv, float* out, float* partials,
                        unsigned* counters, int B, int V, int C, int ct, int nsplit, int chunk,
                        bool cluster, cudaStream_t stream) {
  const dim3 grid((C + ct * VEC - 1) / (ct * VEC), nsplit, B);
  auto* kernel = cluster ? &gn_sums_onepass<T, VEC, true> : &gn_sums_onepass<T, VEC, false>;
  return launch(kernel, grid, cluster, stream, static_cast<const T*>(x), sb, sv, out, partials,
                counters, V, C, ct, chunk);
}

template <typename T, int VEC>
cudaError_t launch_bwd_sums(const void* dy, const void* x, const float* mean, const float* inv,
                            int64_t xsb, int64_t xsv, int64_t dsb, int64_t dsv, int64_t dsc,
                            float* out, float* partials, unsigned* counters, int B, int V, int C,
                            int ct, int nsplit, int chunk, bool cluster, cudaStream_t stream) {
  const dim3 grid((C + ct * VEC - 1) / (ct * VEC), nsplit, B);
  auto* kernel =
      cluster ? &gn_bwd_sums_onepass<T, VEC, true> : &gn_bwd_sums_onepass<T, VEC, false>;
  return launch(kernel, grid, cluster, stream, static_cast<const T*>(x), static_cast<const T*>(dy),
                mean, inv, xsb, xsv, dsb, dsv, dsc, out, partials, counters, V, C, ct, chunk);
}

// A plan the grids cannot take: sizes, lanes, chunks (none empty), cluster
// size, and the load width (16 bytes of the dtype dividing C, or 1).
bool bad_plan(int is_bf16, int B, int V, int C, int vec, int ct, int nsplit, int chunk,
              int cluster) {
  const bool ct_ok = ct >= 1 && ct <= 32 && (ct & (ct - 1)) == 0 && ct * vec <= GN_MAX_CW;
  return B <= 0 || V <= 0 || C <= 0 || B > 65535 || nsplit <= 0 || nsplit > 65535 || !ct_ok ||
         chunk <= 0 || (int64_t)(nsplit - 1) * chunk >= V || (int64_t)nsplit * chunk < V ||
         (cluster && nsplit > GN_MAX_CLUSTER) ||
         (vec != 1 && (vec != (is_bf16 ? 8 : 4) || C % vec != 0));
}

// An operand that 16-byte loads of vec elements cannot read.
bool misaligned(const void* p, int64_t sb, int64_t sv, int vec) {
  return sb % vec != 0 || sv % vec != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0;
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
  if (bad_plan(is_bf16, B, V, C, vec, ct, nsplit, chunk, cluster) ||
      (vec != 1 && misaligned(x, sb, sv, vec)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool cl = cluster != 0;
  if (is_bf16) {
    if (vec == 8)
      return (int)launch_sums<__nv_bfloat16, 8>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit, chunk,
                                                cl, s);
    return (int)launch_sums<__nv_bfloat16, 1>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit, chunk,
                                              cl, s);
  }
  if (vec == 4)
    return (int)launch_sums<float, 4>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit, chunk, cl, s);
  return (int)launch_sums<float, 1>(x, sb, sv, o, p, cnt, B, V, C, ct, nsplit, chunk, cl, s);
}

// dy, x: (B, V, C) of one dtype; x with unit channel stride through its
// batch and voxel element strides xsb, xsv, dy through dsb, dsv, dsc. mean,
// inv: contiguous (B, C) fp32. vec, ct, nsplit, chunk, cluster, out,
// partials and counters as ldm3d_gn_sums's; with vec > 1 both x and dy sit
// on 16 bytes with batch and voxel strides that vec divides, and dsc = 1.
// One launch; returns its cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_gn_bwd_sums(const void* dy, const void* x, const void* mean, const void* inv,
                                 void* out, void* partials, void* counters, int is_bf16, int B,
                                 int V, int C, int64_t xsb, int64_t xsv, int64_t dsb, int64_t dsv,
                                 int64_t dsc, int vec, int ct, int nsplit, int chunk, int cluster,
                                 void* stream) {
  if (bad_plan(is_bf16, B, V, C, vec, ct, nsplit, chunk, cluster) ||
      (vec != 1 && (misaligned(x, xsb, xsv, vec) || misaligned(dy, dsb, dsv, vec) || dsc != 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(mean);
  const auto* iv = static_cast<const float*>(inv);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partials);
  unsigned* cnt = static_cast<unsigned*>(counters);
  const bool cl = cluster != 0;
  if (is_bf16) {
    if (vec == 8)
      return (int)launch_bwd_sums<__nv_bfloat16, 8>(dy, x, m, iv, xsb, xsv, dsb, dsv, dsc, o, p,
                                                    cnt, B, V, C, ct, nsplit, chunk, cl, s);
    return (int)launch_bwd_sums<__nv_bfloat16, 1>(dy, x, m, iv, xsb, xsv, dsb, dsv, dsc, o, p,
                                                  cnt, B, V, C, ct, nsplit, chunk, cl, s);
  }
  if (vec == 4)
    return (int)launch_bwd_sums<float, 4>(dy, x, m, iv, xsb, xsv, dsb, dsv, dsc, o, p, cnt, B, V,
                                          C, ct, nsplit, chunk, cl, s);
  return (int)launch_bwd_sums<float, 1>(dy, x, m, iv, xsb, xsv, dsb, dsv, dsc, o, p, cnt, B, V, C,
                                        ct, nsplit, chunk, cl, s);
}
