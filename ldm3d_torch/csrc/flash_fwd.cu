// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas forward kernels of ldm3d_tpu/ops/attention.py:
// _flash_kernel_mono (k/v resident in VMEM, line 49, launched at :255) and
// _flash_kernel (k/v streamed over an inner grid axis, line 83, launched at
// :274). On the TPU the choice between them was a VMEM-budget question; here
// one kernel covers both, because a thread block always streams k/v tiles
// through shared memory.
//
// What it computes, per (batch, head):
//   O   = softmax(q k^T / sqrt(d)) v      (in the input dtype)
//   LSE = rowwise logsumexp(q k^T / sqrt(d))   (fp32, the backward's residual)
//
// What bounds it on the H100: the work is 4*n*kv*d flops against (3+1)*n*d
// elements of traffic. In bf16 the shapes that carry the models' attention
// time are bound by the tensor cores' 989 TFLOP/s: (20, 8000, 1, 256) needs
// 1.31 TFLOP, 1.325 ms, against 0.098 ms of bytes; (., 1000, 8, 64) does
// about 500 flops a byte, above the card's ridge of ~295. The UNet's 5^3
// level (n = 125) is bound by its bytes (1 MB a call at batch 1, 0.3 us) and
// in practice by the launch itself.
//
// Two routes, by dtype; no switch and no fallback between them:
//
// * bf16: flash_fwd_bf16_mma_kernel, FlashAttention-2 on the warp-level
//   tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators). The
//   building blocks are in mma_sm90.cuh.
//   - grid = (ceil(n / 128), batch * heads); a block of 8 warps owns 128
//     query rows, each warp 16 of them, and loops over kv tiles of 64 keys
//     inside the block, as the TPU's sequential grid axis did.
//   - S = Q K^T and O += P V on the tensor cores; Q and K reach them through
//     ldmatrix, V through ldmatrix.trans (it is the k-major B operand of
//     P V). P goes from the S accumulators straight into bf16 A fragments in
//     registers (the m16n8 C layout is the m16k16 A layout): it never passes
//     through shared memory.
//   - online softmax in fp32 registers: the row max reduces over the four
//     lanes of a quad, exp2 takes S * scale * log2(e) minus the running max
//     in one fma (q is not pre-scaled in bf16: 1/sqrt(d) is not a power of
//     two for every d), and each lane keeps its partial row sum of the fp32
//     P until the end. LSE converts back to the natural log.
//   - bf16 tiles stay bf16 in shared memory, rows padded by 16 bytes so the
//     8 rows of an ldmatrix fall in 8 different bank groups. Q is copied once
//     with cp.async (16 bytes a thread). The K and V tiles stream through a
//     ring of four slots in the order K_0, V_0, K_1, V_1, ...: while one
//     slot is multiplied the copies of the next three are in flight
//     (cp.async.commit_group / wait_group), one barrier per slot.
//   - why 128 rows a block: every block reads all of its head's K and V, and
//     at d = 256 that is 1 KB a key for 4 * rows * 256 flops, so 64-row
//     blocks ask the L2 for 64 flops a byte, 15 TB/s at the tensor-core peak;
//     128 rows halve it. The register file caps a block at 8 warps here: the
//     O accumulator alone is DMAX / 2 fp32 registers a thread, 128 at
//     d = 256. Shared memory: 55,296, 104,448 and 202,752 bytes for
//     DMAX = 64, 128 and 256.
//   - O is staged through the warp's own rows of the Q tile (no block
//     barrier) and written in 16-byte pieces.
//   The one rounding the fp32 plain version does not have is P to bf16
//   before P V, as in FlashAttention-2 (about 2^-9 of |O|); the row sums and
//   the LSE use the fp32 P.
//   Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 7.25 ms at
//   (20, 8000, 1, 256), 181 TFLOP/s, 5.5x its tensor-core bound; the scalar
//   design it replaces took 85.9 ms (PERF.md).
//
// * fp32: flash_fwd_fp32_kernel, scalar fp32 FMA. Tensor cores in fp32 would
//   mean TF32, which the fp32 tolerance (1e-4) does not allow. q (pre-scaled),
//   the current k or v tile and P live in shared memory as fp32 with a row
//   pitch of d+1 floats; thread (ty, tx) of a 16 x 16 block owns rows
//   ty + 16*i and head-dim columns tx + 16*c; 148 KB of shared memory at
//   d = 256. It is the serving path (the JAX server serves fp32).
//
// Both routes mask the ragged edges: query rows past n load zeros and store
// nothing, keys past kv_len score -inf, and head dims past d (any multiple of
// 8 up to 256) are zero in shared memory and not stored. q, k and v are read
// through their (B, n, h, d) strides, so the views that split the attention
// block's fused qkv projection need no copy; the bf16 route needs their base
// pointers and strides on 16 bytes (the wrapper checks).

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90

// The opt-in above 48 KB of dynamic shared memory is made once per device for
// each instantiation, at the most it can need, and not on every launch: one
// bit per device in `opted_in`.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& opted_in) {
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

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int MMA_WARPS = 8;
constexpr int MMA_BM = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_NT = 32 * MMA_WARPS;  // threads per block
constexpr int MMA_BN = 64;              // keys per K or V tile
constexpr int MMA_SLOTS = 4;            // K or V tiles in the shared-memory ring

template <int DMAX>
constexpr size_t mma_smem_bytes() {
  // the Q tile and the ring's slots, rows of DMAX + 8 bf16
  return (size_t)(MMA_BM + MMA_SLOTS * MMA_BN) * (DMAX + 8) * sizeof(bf16);
}

// Start the copy of rows [row0, row0 + ROWS) of one (batch, head) slice into
// a tile of pitch LD: `chunks` 16-byte pieces a row (d rounded up to 16);
// pieces of rows past `valid` or of columns past d are zero-filled.
template <int ROWS, int LD, int DMAX>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int64_t row_stride, int row0, int valid, int d,
                                                int chunks) {
  constexpr int CH = DMAX / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CH; i += MMA_NT) {
    const int r = i / CH;
    const int c = i % CH;
    if (c >= chunks) continue;
    const int t = row0 + r;
    const bool ok = t < valid && c * 8 < d;
    ldm3d::cp_async_16(ldm3d::smem_u32(dst + r * LD + c * 8),
                       ok ? src + (int64_t)t * row_stride + c * 8 : src, ok);
  }
}

// Grid (ceil(n / MMA_BM), batch * heads); MMA_WARPS warps of 16 query rows.
// The kv tiles stream through a ring of MMA_SLOTS slots as the sequence K_0,
// V_0, K_1, V_1, ...: while one slot is multiplied, the copies of the next
// MMA_SLOTS - 1 are in flight.
// At DMAX = 64 two blocks fit an SM (118 registers a thread); from 128 on
// one block takes the register file, and without that bound ptxas would cap
// the registers at 128 and spill the accumulators.
template <int DMAX>
__global__ void __launch_bounds__(MMA_NT, DMAX <= 64 ? 2 : 1) flash_fwd_bf16_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int n, int kv_len, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, float scale_log2) {
  constexpr int BM = MMA_BM;
  constexpr int BN = MMA_BN;
  constexpr int NSLOT = MMA_SLOTS;
  constexpr int LD = DMAX + 8;    // shared-memory row pitch, bf16
  constexpr int KS = DMAX / 16;   // k-steps of Q K^T over the head dim
  constexpr int SN = BN / 8;      // 8-key n-tiles of S
  constexpr int ON = DMAX / 8;    // 8-column n-tiles of O
  static_assert(BN % 16 == 0 && DMAX % 16 == 0 && NSLOT >= 2, "tiles are whole mma steps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BM x LD
  bf16* slots = qs + BM * LD;                    // NSLOT x BN x LD

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // C rows g and g + 8
  const int t = lane % 4;  // C columns 2t and 2t + 1
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * BM;
  const int chunks = (d + 15) / 16 * 2;
  const int n_items = 2 * ((kv_len + BN - 1) / BN);

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  // one commit group per item, empty past the last, so that before item i
  // the groups of items i + 1 .. i + NSLOT - 2 are the only ones in flight
  auto issue = [&](int item) {
    if (item < n_items) {
      const bool is_v = item & 1;
      load_tile_async<BN, LD, DMAX>(slots + item % NSLOT * BN * LD, is_v ? vb : kb,
                                    is_v ? v_sn : k_sn, item / 2 * BN, kv_len, d, chunks);
    }
    ldm3d::cp_async_commit();
  };
  load_tile_async<BM, LD, DMAX>(qs, qb, q_sn, row0, n, d, chunks);  // with item 0
#pragma unroll
  for (int i = 0; i < NSLOT - 1; ++i) issue(i);

  // Each lane's ldmatrix row address (see mma_sm90.cuh for the fragments):
  // Q (A): rows lane % 16 of the warp's 16, column half lane / 16;
  // K (B of two n-tiles): keys lane % 8 + 8 * (lane / 16), dim half (lane / 8) % 2;
  // V (B via .trans, two n-tiles): keys lane % 16, dim half lane / 16.
  const uint32_t q_addr = ldm3d::smem_u32(qs + (warp * 16 + lane % 16) * LD + lane / 16 * 8);
  const uint32_t k_addr = ldm3d::smem_u32(slots + (lane % 8 + lane / 16 * 8) * LD +
                                          (lane / 8) % 2 * 8);
  const uint32_t v_addr = ldm3d::smem_u32(slots + lane % 16 * LD + lane / 16 * 8);
  constexpr uint32_t SLOT_BYTES = BN * LD * sizeof(bf16);

  float acc[ON][4];
#pragma unroll
  for (int c = 0; c < ON; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of S * scale * log2(e)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums of P

  for (int item = 0; item < n_items; item += 2) {
    // K_j: landed for every thread; every warp is done with the slot that
    // the copy of item + NSLOT - 1 now overwrites
    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(item + NSLOT - 1);
    const uint32_t ks = k_addr + item % NSLOT * SLOT_BYTES;

    float s[SN][4];
#pragma unroll
    for (int c = 0; c < SN; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 16 >= d) continue;  // columns past d rounded up to 16 are not loaded
      uint32_t a[4];
      ldm3d::ldmatrix_x4(a, q_addr + kk * 16 * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < SN; c += 2) {
        uint32_t bk[4];
        ldm3d::ldmatrix_x4(bk, ks + (c * 8 * LD + kk * 16) * sizeof(bf16));
        ldm3d::mma_bf16_16816(s[c], a, bk[0], bk[1]);
        ldm3d::mma_bf16_16816(s[c + 1], a, bk[2], bk[3]);
      }
    }

    const int kv0 = item / 2 * BN;
    if (kv0 + BN > kv_len) {
#pragma unroll
      for (int c = 0; c < SN; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + c * 8 + 2 * t + (e & 1) >= kv_len) s[c][e] = -INFINITY;
    }

    // online softmax; every tile holds a valid key (kv0 < kv_len), so the
    // new max is finite and exp2(-inf) zeroes the masked keys
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < SN; ++c) {
      mt[0] = fmaxf(mt[0], fmaxf(s[c][0], s[c][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[c][2], s[c][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r] * scale_log2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int c = 0; c < ON; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }

    // V_j
    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(item + NSLOT);
    const uint32_t vs = v_addr + (item + 1) % NSLOT * SLOT_BYTES;

#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      // P of these 16 keys in fp32 for the row sums, rounded to bf16 into
      // one A fragment: n-tile 2kk fills registers 0 and 1, 2kk + 1 2 and 3
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 2 * kk + half;
        const float p0 = exp2f(fmaf(s[c][0], scale_log2, -m[0]));
        const float p1 = exp2f(fmaf(s[c][1], scale_log2, -m[0]));
        const float p2 = exp2f(fmaf(s[c][2], scale_log2, -m[1]));
        const float p3 = exp2f(fmaf(s[c][3], scale_log2, -m[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * half] = ldm3d::pack_bf16(p0, p1);
        pa[2 * half + 1] = ldm3d::pack_bf16(p2, p3);
      }
      if (kv0 + kk * 16 >= kv_len) continue;  // all-masked keys: P = 0
#pragma unroll
      for (int c = 0; c < ON; c += 2) {
        if (c * 8 >= d) continue;
        uint32_t bv[4];
        ldm3d::ldmatrix_x4_trans(bv, vs + (kk * 16 * LD + c * 8) * sizeof(bf16));
        ldm3d::mma_bf16_16816(acc[c], pa, bv[0], bv[1]);
        ldm3d::mma_bf16_16816(acc[c + 1], pa, bv[2], bv[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }

  // O through the warp's own 16 rows of the Q tile (no other warp reads
  // them), then 16-byte stores of the valid rows and d columns
  __syncwarp();
  bf16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int c = 0; c < ON; ++c) {
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + c * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[c][0] * inv[0], acc[c][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + c * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[c][2] * inv[1], acc[c][3] * inv[1]);
  }
  __syncwarp();
  const int row_w = row0 + warp * 16;
  const int dch = d / 8;
  for (int i = lane; i < 16 * dch; i += 32) {
    const int r = i / dch;
    const int c = i - r * dch;
    if (row_w + r < n)
      *reinterpret_cast<uint4*>(o + ((int64_t)(b * n + row_w + r) * H + h) * d + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_w + g + 8 * r;
      if (row < n) lse[(int64_t)bh * n + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

template <int DMAX>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int H, int n, int kv_len, int d, const int64_t* st, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DMAX>();
  static_assert(smem <= MAX_SMEM, "tiles exceed the shared memory of a block");
  auto kernel = flash_fwd_bf16_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + MMA_BM - 1) / MMA_BM, B * H);
  kernel<<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, n, kv_len, d, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA

constexpr int BM = 64;            // query rows per block
constexpr int BN = 64;            // key rows per kv tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;       // threads per block
constexpr int RM = BM / TY;       // query rows per thread
constexpr int RN = BN / TX;       // key columns per thread

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
// with pitch d+1; rows past `valid` are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t row_stride, int row0, int rows, int valid, int d,
                                          float mul) {
  const int ld = d + 1;
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d;
    const int c = i - r * d;
    const int t = row0 + r;
    dst[r * ld + c] = t < valid ? src[(int64_t)t * row_stride + c] * mul : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int n, int kv_len, int d,
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

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
    float* orow = o + ((int64_t)(b * n + t) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + TX * c;
      if (col < d) orow[col] = acc[i][c] / l[i];
    }
    if (tx == 0) lse[(int64_t)bh * n + t] = m[i] + logf(l[i]);
  }
}

constexpr size_t smem_bytes(int d) {
  return (size_t)((BM + BN) * (d + 1) + BM * (BN + 1)) * sizeof(float);
}

template <int DMAX>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int H, int n, int kv_len, int d, const int64_t* st, float scale,
                        cudaStream_t stream) {
  static_assert(smem_bytes(DMAX) <= MAX_SMEM, "tiles exceed the shared memory of a block");
  const size_t smem = smem_bytes(d);
  if (smem > smem_bytes(DMAX)) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_fp32_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem_bytes(DMAX), opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, n, kv_len, d, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, n|kv_len, H, d) with unit stride on d; strides in elements,
// ordered (q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh); in bf16
// the base pointers and strides are multiples of 16 bytes.
// o: contiguous (B, n, H, d) in the input dtype. lse: contiguous (B*H, n) fp32.
// Returns the launch's cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int is_bf16, int B, int H, int n, int kv_len, int d,
                               const int64_t* st, float scale, void* stream) {
  if (B <= 0 || H <= 0 || n <= 0 || kv_len <= 0 || d <= 0 || d > 256 || d % 8 != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (d <= 64) return (int)launch_bf16<64>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
    if (d <= 128) return (int)launch_bf16<128>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
    return (int)launch_bf16<256>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
  }
  if (d <= 64) return (int)launch_fp32<64>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
  if (d <= 128) return (int)launch_fp32<128>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
  return (int)launch_fp32<256>(q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
}
