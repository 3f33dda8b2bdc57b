// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas backward kernels of ldm3d_tpu/ops/attention.py:
// _flash_dq_kernel (line 122, launched at :310) and _flash_dkv_kernel (line
// 150, launched at :331). On the TPU each carried fp32 accumulators in VMEM
// scratch across a sequential innermost grid axis; here that axis is a loop
// inside the block, and the accumulators stay in fp32 registers. Nothing is
// summed across blocks, so there are no atomics and the result is
// deterministic.
//
// What it computes, per (batch, head), from the forward's O and row LSE and
// D = rowsum(dO * O) (fp32, computed by the caller):
//   P  = exp(scale * Q K^T - LSE)          (recomputed tile by tile)
//   dS = P * (dO V^T - D)
//   dQ = scale * dS K                       (kernel flash_bwd_dq)
//   dV = P^T dO,  dK = scale * dS^T Q       (kernel flash_bwd_dkv)
// in fp32, stored in the input dtype.
//
// What bounds it on the H100: dQ does 6*n*kv*d flops and dK/dV 8*n*kv*d per
// head against (4+1)*n*d and (4+2)*n*d elements of traffic, so at the
// flagship's d = 64 and n = 1000 both are compute-bound on the bf16 tensor
// cores (989 TFLOP/s); the 125-token level is bound by its bytes. Like
// flash_fwd.cu this first version is scalar fp32 FMA fed from shared
// memory, right before fast: tensor cores (mma.sync, then wgmma + TMA) are
// later work.
//
// Design:
//   * dQ: grid = (ceil(n / BM), batch * heads); one block of 256 threads owns
//     BM query rows and loops over kv tiles of BN keys. q (pre-scaled), dO,
//     the k tile and the v tile sit in shared memory as fp32 with a row pitch
//     of d+1 floats (16 threads reading 16 rows at one column hit 16 banks);
//     dS goes through shared memory for the dS K product.
//   * dK/dV: grid = (ceil(kv_len / BN), batch * heads); one block owns BN key
//     rows, keeps its k and v tiles resident and loops over q tiles of BM
//     rows (q pre-scaled, dO, and that tile's LSE and D). P^T and dS^T go
//     through shared memory, key-major.
//   * thread (ty, tx) of a 16 x 16 block owns output rows ty + 16*i and
//     head-dim columns tx + 16*c; the score tile's columns are tx + 16*j.
//   * ragged edges: rows past n and keys past kv_len load zeros, get P = 0
//     and store nothing, so no token count needs a divisor. q, k, v and dO
//     are read through their (B, n, h, d) strides: the attention block's q,
//     k, v are strided views of one fused qkv projection.
//   * head_dim: any multiple of 8 up to 256, as the forward. Tiles by the
//     instantiation's largest d (DMAX): BM = BN = 64 up to d = 128; at
//     d = 256, dQ takes BN = 32 and dK/dV takes BM = BN = 32, which keeps the
//     shared memory at 201 KB and 137 KB and the register accumulators at 64
//     and 2 x 32 floats a thread. Every instantiation's shared memory is
//     checked against the 227 KB a block may use at compile time, and each
//     launch against its instantiation.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;          // threads per block
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy rows [row0, row0 + rows) of one (batch, head) slice into shared memory
// as fp32 with pitch d+1, times `mul`; rows past `valid` are zero.
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

// Tile sizes of an instantiation: BM query rows, BN key rows.
template <int DMAX>
struct DqTiles {
  static constexpr int BM = 64;
  static constexpr int BN = DMAX > 128 ? 32 : 64;
};
template <int DMAX>
struct DkvTiles {
  static constexpr int BM = DMAX > 128 ? 32 : 64;
  static constexpr int BN = DMAX > 128 ? 32 : 64;
};

constexpr size_t dq_smem_bytes(int d, int bm, int bn) {
  return (size_t)((2 * bm + 2 * bn) * (d + 1) + bm * (bn + 1)) * sizeof(float);
}
constexpr size_t dkv_smem_bytes(int d, int bm, int bn) {
  return (size_t)((2 * bm + 2 * bn) * (d + 1) + 2 * bn * (bm + 1) + 2 * bm) * sizeof(float);
}

struct Strides {
  int64_t q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, int H, int n, int kv_len, int d, Strides st, float scale) {
  constexpr int BM = DqTiles<DMAX>::BM;
  constexpr int BN = DqTiles<DMAX>::BN;
  constexpr int RM = BM / TY;    // query rows per thread
  constexpr int RN = BN / TX;    // key columns per thread
  constexpr int RD = DMAX / TX;  // head-dim columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;             // BM x ld, pre-scaled q
  float* dos = qs + BM * ld;    // BM x ld, dO
  float* ks = dos + BM * ld;    // BN x ld
  float* vs = ks + BN * ld;     // BN x ld
  float* dss = vs + BN * ld;    // BM x (BN + 1), dS

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;

  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const T* ob = dout + b * st.o_sb + h * st.o_sh;

  load_tile(qs, qb, st.q_sn, row0, BM, n, d, scale);
  load_tile(dos, ob, st.o_sn, row0, BM, n, d, 1.f);

  float row_lse[RM];
  float row_d[RM];
  float acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = row0 + ty + TY * i;
    row_lse[i] = t < n ? lse[(int64_t)bh * n + t] : 0.f;
    row_d[i] = t < n ? dvec[(int64_t)bh * n + t] : 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += BN) {
    __syncthreads();  // q/dO are loaded; the previous k tile and dS are no longer read
    load_tile(ks, kb, st.k_sn, kv0, BN, kv_len, d, 1.f);
    load_tile(vs, vb, st.v_sn, kv0, BN, kv_len, d, 1.f);
    __syncthreads();

    float s[RM][RN];
    float dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float qv[RM], ov[RM], kv[RN], vv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = qs[(ty + TY * i) * ld + c];
        ov[i] = dos[(ty + TY * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        kv[j] = ks[(tx + TX * j) * ld + c];
        vv[j] = vs[(tx + TX * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const bool row_ok = row0 + ty + TY * i < n;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const bool col_ok = kv0 + tx + TX * j < kv_len;
        const float p = row_ok && col_ok ? expf(s[i][j] - row_lse[i]) : 0.f;
        dss[(ty + TY * i) * (BN + 1) + tx + TX * j] = p * (dp[i][j] - row_d[i]);
      }
    }
    __syncthreads();  // dS is visible

    const int nk = min(BN, kv_len - kv0);
    for (int kk = 0; kk < nk; ++kk) {
      float dsv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = dss[(ty + TY * i) * (BN + 1) + kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const int col = tx + TX * c;
        const float kval = col < d ? ks[kk * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(dsv[i], kval, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = row0 + ty + TY * i;
    if (t >= n) continue;
    T* out = dq + ((int64_t)(b * n + t) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + TX * c;
      if (col < d) store_as(out + col, scale * acc[i][c]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, int H, int n, int kv_len, int d, Strides st,
    float scale) {
  constexpr int BM = DkvTiles<DMAX>::BM;
  constexpr int BN = DkvTiles<DMAX>::BN;
  constexpr int RK = BN / TY;    // key rows per thread
  constexpr int RQ = BM / TX;    // query columns of the score tile per thread
  constexpr int RD = DMAX / TX;  // head-dim columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;              // BN x ld
  float* vs = ks + BN * ld;      // BN x ld
  float* qs = vs + BN * ld;      // BM x ld, pre-scaled q
  float* dos = qs + BM * ld;     // BM x ld, dO
  float* pt = dos + BM * ld;     // BN x (BM + 1), P^T
  float* dst = pt + BN * (BM + 1);   // BN x (BM + 1), dS^T
  float* lse_s = dst + BN * (BM + 1);  // BM
  float* d_s = lse_s + BM;             // BM

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int key0 = blockIdx.x * BN;

  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const T* ob = dout + b * st.o_sb + h * st.o_sh;

  load_tile(ks, kb, st.k_sn, key0, BN, kv_len, d, 1.f);
  load_tile(vs, vb, st.v_sn, key0, BN, kv_len, d, 1.f);

  float acc_k[RK][RD];
  float acc_v[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < RD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BM) {
    __syncthreads();  // k/v are loaded; the previous q tile, P^T and dS^T are no longer read
    load_tile(qs, qb, st.q_sn, q0, BM, n, d, scale);
    load_tile(dos, ob, st.o_sn, q0, BM, n, d, 1.f);
    for (int r = threadIdx.x; r < BM; r += NT) {
      const int t = q0 + r;
      lse_s[r] = t < n ? lse[(int64_t)bh * n + t] : 0.f;
      d_s[r] = t < n ? dvec[(int64_t)bh * n + t] : 0.f;
    }
    __syncthreads();

    float s[RK][RQ];
    float dp[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float kv[RK], vv[RK], qv[RQ], ov[RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = ks[(ty + TY * i) * ld + c];
        vv[i] = vs[(ty + TY * i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        qv[j] = qs[(tx + TX * j) * ld + c];
        ov[j] = dos[(tx + TX * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const bool key_ok = key0 + ty + TY * i < kv_len;
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int r = tx + TX * j;
        const bool row_ok = q0 + r < n;
        const float p = key_ok && row_ok ? expf(s[i][j] - lse_s[r]) : 0.f;
        pt[(ty + TY * i) * (BM + 1) + r] = p;
        dst[(ty + TY * i) * (BM + 1) + r] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();  // P^T and dS^T are visible

    const int nq = min(BM, n - q0);
    for (int qq = 0; qq < nq; ++qq) {
      float pv[RK], dsv[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = pt[(ty + TY * i) * (BM + 1) + qq];
        dsv[i] = dst[(ty + TY * i) * (BM + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const int col = tx + TX * c;
        const float ov = col < d ? dos[qq * ld + col] : 0.f;
        const float qv = col < d ? qs[qq * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = key0 + ty + TY * i;
    if (t >= kv_len) continue;
    const int64_t base = ((int64_t)(b * kv_len + t) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + TX * c;
      if (col < d) {
        store_as(dk + base + col, acc_k[i][c]);  // q was pre-scaled: dK = scale * dS^T Q
        store_as(dv + base + col, acc_v[i][c]);
      }
    }
  }
}

// The opt-in above 48 KB of dynamic shared memory is made once per device
// for each instantiation, at the most it can need (d = DMAX), and not on
// every launch: one bit per device.
template <typename K>
cudaError_t opt_in_once(K kernel, size_t bytes, std::atomic<unsigned long long>& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((opted_in.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted_in.fetch_or(1ull << dev);
  }
  return cudaSuccess;
}

template <typename T, int DMAX>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dvec, void* dq, int B, int H, int n,
                      int kv_len, int d, const Strides& st, float scale, cudaStream_t stream) {
  constexpr int BM = DqTiles<DMAX>::BM;
  constexpr int BN = DqTiles<DMAX>::BN;
  static_assert(dq_smem_bytes(DMAX, BM, BN) <= MAX_SMEM, "dQ tiles exceed a block's shared memory");
  const size_t smem = dq_smem_bytes(d, BM, BN);
  if (smem > dq_smem_bytes(DMAX, BM, BN)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, dq_smem_bytes(DMAX, BM, BN), opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dq), H, n, kv_len, d, st, scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dvec, void* dk, void* dv, int B, int H,
                       int n, int kv_len, int d, const Strides& st, float scale,
                       cudaStream_t stream) {
  constexpr int BM = DkvTiles<DMAX>::BM;
  constexpr int BN = DkvTiles<DMAX>::BN;
  static_assert(dkv_smem_bytes(DMAX, BM, BN) <= MAX_SMEM,
                "dK/dV tiles exceed a block's shared memory");
  const size_t smem = dkv_smem_bytes(d, BM, BN);
  if (smem > dkv_smem_bytes(DMAX, BM, BN)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, dkv_smem_bytes(DMAX, BM, BN), opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((kv_len + BN - 1) / BN, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk), static_cast<T*>(dv), H, n, kv_len,
      d, st, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int n, int kv_len, int d) {
  return B <= 0 || H <= 0 || n <= 0 || kv_len <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
         B * H > 65535;
}

Strides to_strides(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// q, dO: (B, n, H, d); k, v: (B, kv_len, H, d); each with unit stride on d.
// strides: 12 int64 element strides, (sb, sn, sh) of q, k, v, dO in that order.
// lse, dvec: contiguous (B*H, n) fp32. dq: contiguous (B, n, H, d) in the input dtype.
// Returns the launch's cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* dvec, void* dq, int is_bf16, int B,
                                  int H, int n, int kv_len, int d, const int64_t* strides,
                                  float scale, void* stream) {
  if (bad_shape(B, H, n, kv_len, d)) return (int)cudaErrorInvalidValue;
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDM3D_DQ(T, D) launch_dq<T, D>(q, k, v, dout, lse, dvec, dq, B, H, n, kv_len, d, st, scale, s)
  if (is_bf16) {
    if (d <= 64) return (int)LDM3D_DQ(__nv_bfloat16, 64);
    if (d <= 128) return (int)LDM3D_DQ(__nv_bfloat16, 128);
    return (int)LDM3D_DQ(__nv_bfloat16, 256);
  }
  if (d <= 64) return (int)LDM3D_DQ(float, 64);
  if (d <= 128) return (int)LDM3D_DQ(float, 128);
  return (int)LDM3D_DQ(float, 256);
#undef LDM3D_DQ
}

// As ldm3d_flash_bwd_dq; dk, dv: contiguous (B, kv_len, H, d) in the input dtype.
extern "C" int ldm3d_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* dvec, void* dk, void* dv,
                                   int is_bf16, int B, int H, int n, int kv_len, int d,
                                   const int64_t* strides, float scale, void* stream) {
  if (bad_shape(B, H, n, kv_len, d)) return (int)cudaErrorInvalidValue;
  const Strides st = to_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDM3D_DKV(T, D) \
  launch_dkv<T, D>(q, k, v, dout, lse, dvec, dk, dv, B, H, n, kv_len, d, st, scale, s)
  if (is_bf16) {
    if (d <= 64) return (int)LDM3D_DKV(__nv_bfloat16, 64);
    if (d <= 128) return (int)LDM3D_DKV(__nv_bfloat16, 128);
    return (int)LDM3D_DKV(__nv_bfloat16, 256);
  }
  if (d <= 64) return (int)LDM3D_DKV(float, 64);
  if (d <= 128) return (int)LDM3D_DKV(float, 128);
  return (int)LDM3D_DKV(float, 256);
#undef LDM3D_DKV
}
