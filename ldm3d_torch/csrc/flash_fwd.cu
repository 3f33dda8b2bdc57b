// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas forward kernels of ldm3d_tpu/ops/attention.py:
// _flash_kernel_mono (k/v resident in VMEM, line 49) and _flash_kernel (k/v
// streamed over an inner grid axis, line 83). On the TPU the choice between
// them was a VMEM-budget question; here one kernel covers both, because a
// thread block always streams k/v tiles through shared memory.
//
// What it computes, per (batch, head):
//   O   = softmax(q k^T / sqrt(d)) v      (in the input dtype)
//   LSE = rowwise logsumexp(q k^T / sqrt(d))   (fp32, the backward's residual)
// with the online softmax and both products accumulated in fp32.
//
// What bounds it on the H100: the work is 4*n*kv*d flops against (3+1)*n*d
// elements of traffic, so the shapes that carry the main path's attention
// time are compute-bound (d=64, n=1000: ~500 flops per byte in bf16; d=256,
// n=8000: ~16000; the card's bf16 ridge is ~295), while the UNet's 5^3 level
// (n=125) is bound by its bytes. The tensor-core bound is 989 TFLOP/s in bf16.
// This first kernel is scalar fp32 FMA (67 TFLOP/s peak, and shared-memory
// loads feed the FMAs at about half that), so it sits well above its bound
// by design: it is the reference-exact version that later tensor-core
// (mma.sync / wgmma) versions are held against.
//
// Design:
//   * grid = (ceil(n / BM), batch * heads); one block of 256 threads owns BM
//     query rows of one (batch, head). A loop over kv tiles inside the block
//     takes the place of the TPU's sequential grid axis.
//   * q (pre-scaled), the current k or v tile and the probability tile P live
//     in shared memory as fp32 with a row pitch of d+1 floats, so the 16
//     threads that read 16 different rows at one column hit 16 banks.
//   * thread (ty, tx) owns rows ty + 16*i (i < 4); it computes S for key
//     columns tx + 16*j (j < 4) and the output for head-dim columns
//     tx + 16*c (c < DMAX/16). The 16 threads of one row are one half-warp,
//     so row max and row sum reduce with four xor-shuffles.
//   * fp32 running (m, l, acc) in registers: at DMAX=256 acc is 64 floats a
//     thread, which fits beside the score tile without spilling.
//   * the ragged edges are masked: query rows past n load zeros and store
//     nothing, key columns past kv_len score -inf. No token count needs a
//     divisor, and q/k/v are read through their (B, n, h, d) strides, so the
//     views that split a fused qkv projection need no copy.
//   * dynamic shared memory is (BM + BN) * (d+1) + BM * (BN+1) floats:
//     148 KB at d=256, under the 227 KB a block may use (checked at compile
//     time for each instantiation's largest d).

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // key rows per kv tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;       // threads per block
constexpr int RM = BM / TY;       // query rows per thread
constexpr int RN = BN / TX;       // key columns per thread
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy rows [row0, row0 + rows) of one (batch, head) slice into shared memory
// as fp32 with pitch d+1; rows past `valid` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int64_t row_stride,
                                          int row0, int rows, int valid, int d, float mul) {
  const int ld = d + 1;
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d;
    const int c = i - r * d;
    const int t = row0 + r;
    dst[r * ld + c] = t < valid ? to_float(src[(int64_t)t * row_stride + c]) * mul : 0.f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int n, int kv_len, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, float scale) {
  constexpr int RD = DMAX / TX;  // head-dim columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;              // BM x ld, pre-scaled q
  float* kvs = qs + BM * ld;     // BN x ld, the k tile, then the v tile
  float* ps = kvs + BN * ld;     // BM x (BN + 1), probabilities

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  load_tile(qs, qb, q_sn, row0, BM, n, d, scale);

  float acc[RM][RD];
  float m[RM];
  float l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += BN) {
    __syncthreads();  // q is loaded; the previous v tile is no longer read
    load_tile(kvs, kb, k_sn, kv0, BN, kv_len, d, 1.f);
    __syncthreads();

    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[RM];
      float kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty + TY * i) * ld + c];
#pragma unroll
      for (int j = 0; j < RN; ++j) kv[j] = kvs[(tx + TX * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; every tile holds at least one valid key (kv0 < kv_len),
    // so the new row max is finite and exp(-inf) zeroes the masked columns
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        if (kv0 + tx + TX * j >= kv_len) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < RN; ++j) ps[(ty + TY * i) * (BN + 1) + tx + TX * j] = s[i][j];
    }
    __syncthreads();  // the k tile is no longer read; P is visible
    load_tile(kvs, vb, v_sn, kv0, BN, kv_len, d, 1.f);
    __syncthreads();

    const int nk = min(BN, kv_len - kv0);
    for (int kk = 0; kk < nk; ++kk) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[(ty + TY * i) * (BN + 1) + kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const int col = tx + TX * c;
        const float vv = col < d ? kvs[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = row0 + ty + TY * i;
    if (t >= n) continue;
    T* orow = o + ((int64_t)(b * n + t) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + TX * c;
      if (col < d) store_as(orow + col, acc[i][c] / l[i]);
    }
    if (tx == 0) lse[(int64_t)bh * n + t] = m[i] + logf(l[i]);
  }
}

constexpr size_t smem_bytes(int d) {
  return (size_t)((BM + BN) * (d + 1) + BM * (BN + 1)) * sizeof(float);
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                   int n, int kv_len, int d, const int64_t* st, float scale, cudaStream_t stream) {
  static_assert(smem_bytes(DMAX) <= MAX_SMEM, "tiles exceed the shared memory of a block");
  const size_t smem = smem_bytes(d);
  if (smem > smem_bytes(DMAX)) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<T, DMAX>;
  // The opt-in above 48 KB of dynamic shared memory is made once per device
  // for each instantiation, at the most it can need (d = DMAX), and not on
  // every launch: one bit per device.
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((opted_in.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(DMAX));
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(1ull << dev);
  }
  const dim3 grid((n + BM - 1) / BM, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, n, kv_len, d, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                     int n, int kv_len, int d, const int64_t* st, float scale,
                     cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, stream);
}

}  // namespace

// q, k, v: (B, n|kv_len, H, d) with unit stride on d; strides in elements,
// ordered (q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh).
// o: contiguous (B, n, H, d) in the input dtype. lse: contiguous (B*H, n) fp32.
// Returns the launch's cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int is_bf16, int B, int H, int n, int kv_len, int d,
                               const int64_t* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || kv_len <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse, B, H, n, kv_len, d, strides, scale, s);
  return (int)dispatch<float>(q, k, v, o, lse, B, H, n, kv_len, d, strides, scale, s);
}
