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
// What it computes, per (batch, head), from the forward's row LSE and
// D = rowsum(dO * O) (fp32, computed by the caller):
//   P  = exp(scale * Q K^T - LSE)          (recomputed tile by tile)
//   dS = P * (dO V^T - D)
//   dQ = scale * dS K                       (ldm3d_flash_bwd_dq)
//   dV = P^T dO,  dK = scale * dS^T Q       (ldm3d_flash_bwd_dkv)
// stored in the input dtype.
//
// What bounds it on the H100: dQ does 6*n*kv*d flops and dK/dV 8*n*kv*d per
// head against (4+1)*n*d and (4+2)*n*d elements of traffic, so at the
// flagship's d = 64 and n = 1000 both are bound by the bf16 tensor cores
// (989 TFLOP/s); the 125-token level is bound by its bytes.
//
// Three routes, by dtype and head_dim, in each entry point; no switch and no
// fallback. Each grid puts batch * heads and the row tiles on grid.x (tiles
// of one (batch, head) side by side), where the limit is 2^31 - 1 blocks:
//
// * bf16, d <= 256: flash_bwd_dq_bf16_mma_kernel and
//   flash_bwd_dkv_bf16_mma_kernel, FlashAttention-2's backward on the
//   warp-level tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators;
//   mma_sm90.cuh), as two kernels.
//   - dQ: grid = (batch * heads * ceil(n / 128)); 8 warps own 16 query rows
//     each. Q and dO stay in shared memory; the K and V tiles (32 keys, 64
//     at DMAX = 128) stream through a cp.async ring of (K, V) slots, one
//     barrier a tile. S = Q K^T and dP = dO V^T take K and V through
//     ldmatrix; dQ += dS K takes K through ldmatrix.trans.
//   - dK/dV: grid = (batch * heads * ceil(kv_len / 128), head-dim halves);
//     8 warps own 16 keys each. K and V stay in shared memory; the Q and dO
//     tiles (32 queries) with their LSE and D stream through the ring.
//     S^T = K Q^T and dP^T = V dO^T take Q and dO through ldmatrix;
//     dV += P^T dO and dK += dS^T Q through ldmatrix.trans.
//     At DMAX = 256 the 2 x 16 x 256 accumulators of a warp's keys do not
//     fit its registers: a third grid axis gives each block 128 of the head
//     dims of dK and dV, and S and dP are recomputed for each half.
//   - Tiles and blocks an SM: at DMAX = 64, 32-key (dQ) and 32-query
//     (dK/dV) tiles keep each kernel to 128 registers a thread, so two
//     blocks share an SM, which was faster than one block with 64-row tiles
//     or than blocks of 4 warps (PERF.md). From DMAX = 128 on, the
//     accumulators take one block an SM.
//   - P and dS are made in fp32 registers, P = exp2(S * scale * log2(e) -
//     LSE * log2(e)) in one fma (q is not pre-scaled: 1/sqrt(d) is not a
//     power of two for every d, and a scaled bf16 q would round again), and
//     go from the C fragments straight into A fragments (the m16n8 C layout
//     is the m16k16 A layout): nothing passes through shared memory.
//   - The precision: the tensor cores take bf16, and one rounding of P and
//     dS to bf16 spends up to 0.99 of the port's bf16 limit on the
//     gradients (one bf16 ulp of the largest |grad|; emulated on the CPU in
//     tests/test_torch_attention_grad.py). So each is split into bf16
//     hi = bf16(x) and lo = bf16(x - hi), and each of the three products is
//     two mma.sync on the same B fragment: 20 units of n*kv*d tensor-core
//     work where the algorithm needs 14. The B operands (Q, K, dO) are the
//     bf16 inputs, exact.
//   - dQ and dK are multiplied by the scale once, at the store, which goes
//     through the warp's own rows of the resident tile (no block barrier) in
//     16-byte pieces.
//   - bf16 tiles stay bf16 in shared memory, rows padded by 16 bytes so the
//     8 rows of an ldmatrix fall in 8 different bank groups.
//
// * fp32, d <= 256: flash_bwd_dq_fp32_kernel and flash_bwd_dkv_fp32_kernel,
//   scalar fp32 FMA fed from shared memory (not yet redesigned: the
//   forward's 3xTF32 split on the tensor cores is queued for them).
//   - dQ: one block of 256 threads owns BM query rows and loops over kv
//     tiles of BN keys. q (pre-scaled), dO, the k tile and the v tile sit in
//     shared memory as fp32 with a row pitch of d+1 floats (16 threads
//     reading 16 rows at one column hit 16 banks); dS goes through shared
//     memory for the dS K product.
//   - dK/dV: one block owns BN key rows, keeps its k and v tiles resident
//     and loops over q tiles of BM rows (q pre-scaled, dO, and that tile's
//     LSE and D). P^T and dS^T go through shared memory, key-major.
//   - thread (ty, tx) of a 16 x 16 block owns output rows ty + 16*i and
//     head-dim columns tx + 16*c; the score tile's columns are tx + 16*j.
//   - tiles by DMAX: BM = BN = 64 up to d = 128; at d = 256, dQ takes
//     BN = 32 and dK/dV BM = BN = 32 (201 KB and 137 KB of shared memory).
//
// * d > 256, either dtype: flash_bwd_dq_wide_kernel and
//   flash_bwd_dkv_wide_kernel, scalar FMA. grid.y splits the head dims of dQ
//   (blocks of 128) and of dK and dV (blocks of 64); each block recomputes S
//   and dP over the whole d, streaming 16-dim chunks of Q, dO, K and V
//   through shared memory, and takes its own output dims. A plain route
//   that is right; its times are in PERF.md.
//
// Every route masks the ragged edges without copies: rows past n and keys
// past kv_len load zeros (cp.async with src-size 0 on the bf16 route), P is
// 0 past either edge, and nothing is stored past it; head dims past d (a
// multiple of 8: the wrapper zero-pads other widths) are zero in shared
// memory, skipped as k-steps and not stored. q, k, v and dO are read through their (B, n, h, d) strides:
// the attention block's q, k, v are strided views of one fused qkv
// projection. The bf16 route needs their base pointers and strides on 16
// bytes (the wrapper checks). Every instantiation's shared memory is
// checked against the 227 KB a block may use at compile time.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "scalar_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use on sm_90
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  int64_t q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, o_sb, o_sn, o_sh;
};

// The opt-in above 48 KB of dynamic shared memory is made once per device
// for each instantiation, at the most it can need, and not on every launch:
// one bit per device.
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

// ---------------------------------------------------------------------------
// bf16: tensor cores

constexpr int MMA_WARPS = 8;
constexpr int MMA_NT = 32 * MMA_WARPS;  // threads per block

// dQ: BM query rows a block (16 a warp), BN keys a K or V tile, SLOTS (K, V)
// tile pairs in the ring; rows of LD bf16.
template <int DMAX>
struct DqMma {
  static constexpr int BM = 16 * MMA_WARPS;
  static constexpr int BN = DMAX == 128 ? 64 : 32;
  static constexpr int SLOTS = DMAX > 128 ? 2 : 3;
  static constexpr int LD = DMAX + 8;
  static constexpr size_t SMEM = (size_t)(2 * BM + 2 * SLOTS * BN) * LD * sizeof(bf16);
};

// dK/dV: BN keys a block (16 a warp), DOUT head-dim columns of dK and dV a
// block, BM queries a Q or dO tile, SLOTS (Q, dO, LSE, D) tiles in the ring.
template <int DMAX>
struct DkvMma {
  static constexpr int BN = 16 * MMA_WARPS;
  static constexpr int DOUT = DMAX > 128 ? 128 : DMAX;
  static constexpr int BM = 32;
  static constexpr int SLOTS = DMAX > 128 ? 2 : 3;
  static constexpr int LD = DMAX + 8;
  static constexpr size_t TILE = (size_t)BM * LD * sizeof(bf16);  // bytes of a Q or dO tile
  static constexpr size_t SLOT = 2 * TILE + 2 * BM * sizeof(float);
  static constexpr size_t SMEM = (size_t)2 * BN * LD * sizeof(bf16) + SLOTS * SLOT;
};

// Start the copy of rows [row0, row0 + ROWS) of one (batch, head) slice into
// a tile of pitch LD, 16 bytes a piece: pieces of rows past `valid` or of
// columns past d are zero-filled, columns past d rounded up to 16 are left.
template <int ROWS, int LD, int DMAX>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* __restrict__ src,
                                                int64_t row_stride, int row0, int valid, int d) {
  constexpr int CH = DMAX / 8;
  const int chunks = (d + 15) / 16 * 2;
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

// The same for ROWS fp32 values from a contiguous row (LSE or D), 4 bytes a
// piece (a row of n floats starts on 16 bytes only when 4 divides n).
template <int ROWS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src,
                                               int row0, int valid) {
  for (int i = threadIdx.x; i < ROWS; i += MMA_NT) {
    const bool ok = row0 + i < valid;
    ldm3d::cp_async_4(ldm3d::smem_u32(dst + i), ok ? src + row0 + i : src, ok);
  }
}

// The warp's 16 x cols accumulator tile (n-tiles of 8 columns), times `mul`,
// through its own 16 rows of a shared-memory tile of pitch LD into rows
// [row_w, row_w + 16) of a contiguous (B, rows, H, d) output at head-dim
// column col0, 16 bytes a piece; rows past `valid` and columns past d are
// not stored.
template <int NTILES, int LD>
__device__ __forceinline__ void store_rows(const float (&acc)[NTILES][4], float mul,
                                           bf16* stage, bf16* __restrict__ out, int b, int h,
                                           int H, int rows, int row_w, int valid, int d,
                                           int col0) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < NTILES; ++c) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + c * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[c][0] * mul, acc[c][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + c * 8 + 2 * t) =
        __floats2bfloat162_rn(acc[c][2] * mul, acc[c][3] * mul);
  }
  __syncwarp();
  const int dch = min(NTILES * 8, d - col0) / 8;
  for (int i = lane; i < 16 * dch; i += 32) {
    const int r = i / dch;
    const int c = i - r * dch;
    if (row_w + r < valid)
      *reinterpret_cast<uint4*>(out + ((int64_t)(b * rows + row_w + r) * H + h) * d + col0 +
                                c * 8) = *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

// dQ. Grid (batch * heads * ceil(n / BM)). The K and V tiles stream through a
// ring of SLOTS (K_j, V_j) pairs: while one pair is multiplied, the copies
// of the next SLOTS - 1 are in flight. The accumulators of S, dP and dQ take
// BN / 2 + DMAX / 2 fp32 registers a thread: 48 at DMAX = 64, two blocks an
// SM; 128 and 144 above, one block, which without the bound ptxas would cap
// at 128 registers and spill.
template <int DMAX>
__global__ void __launch_bounds__(MMA_NT, DMAX <= 64 ? 2 : 1) flash_bwd_dq_bf16_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dq, int H, int n, int kv_len, int d, Strides st, float scale,
    float scale_log2) {
  using T = DqMma<DMAX>;
  constexpr int BM = T::BM;
  constexpr int BN = T::BN;
  constexpr int NSLOT = T::SLOTS;
  constexpr int LD = T::LD;
  constexpr int KS = DMAX / 16;  // k-steps of Q K^T and dO V^T over the head dim
  constexpr int SN = BN / 8;     // 8-key n-tiles of S and dP
  constexpr int ON = DMAX / 8;   // 8-column n-tiles of dQ
  static_assert(BN % 16 == 0 && DMAX % 16 == 0 && NSLOT >= 2, "tiles are whole mma steps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BM x LD
  bf16* dos = qs + BM * LD;                      // BM x LD
  bf16* slots = dos + BM * LD;                   // NSLOT x (K tile, V tile), each BN x LD

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // C rows g and g + 8
  const int t = lane % 4;  // C columns 2t and 2t + 1
  const int q_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * q_tiles) * BM;
  const int n_tiles = (kv_len + BN - 1) / BN;

  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  const bf16* ob = dout + b * st.o_sb + h * st.o_sh;

  // one commit group per tile, empty past the last, so that before tile j
  // the groups of tiles j + 1 .. j + NSLOT - 2 are the only ones in flight
  auto issue = [&](int j) {
    if (j < n_tiles) {
      bf16* slot = slots + j % NSLOT * 2 * BN * LD;
      load_rows_async<BN, LD, DMAX>(slot, kb, st.k_sn, j * BN, kv_len, d);
      load_rows_async<BN, LD, DMAX>(slot + BN * LD, vb, st.v_sn, j * BN, kv_len, d);
    }
    ldm3d::cp_async_commit();
  };
  load_rows_async<BM, LD, DMAX>(qs, qb, st.q_sn, row0, n, d);  // with tile 0
  load_rows_async<BM, LD, DMAX>(dos, ob, st.o_sn, row0, n, d);
#pragma unroll
  for (int i = 0; i < NSLOT - 1; ++i) issue(i);

  // rows g and g + 8 of the warp: -LSE * log2(e) and D
  float nl[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    nl[r] = row < n ? -lse[(int64_t)bh * n + row] * LOG2E : 0.f;
    dd[r] = row < n ? dvec[(int64_t)bh * n + row] : 0.f;
  }

  // Each lane's ldmatrix row address (mma_sm90.cuh has the fragments):
  // Q, dO (A): rows lane % 16 of the warp's 16, column half lane / 16;
  // K, V (B of S and dP, two n-tiles): keys lane % 8 + 8 * (lane / 16), dim
  // half (lane / 8) % 2; K (B of dS K via .trans, two n-tiles): keys
  // lane % 16, dim half lane / 16.
  const uint32_t q_addr = ldm3d::smem_u32(qs + (warp * 16 + lane % 16) * LD + lane / 16 * 8);
  const uint32_t do_addr = ldm3d::smem_u32(dos + (warp * 16 + lane % 16) * LD + lane / 16 * 8);
  const uint32_t kn_addr = ldm3d::smem_u32(slots + (lane % 8 + lane / 16 * 8) * LD +
                                           (lane / 8) % 2 * 8);
  const uint32_t kt_addr = ldm3d::smem_u32(slots + lane % 16 * LD + lane / 16 * 8);
  constexpr uint32_t SLOT_BYTES = 2 * BN * LD * sizeof(bf16);
  constexpr uint32_t V_BYTES = BN * LD * sizeof(bf16);  // the V tile after the K tile

  float acc[ON][4];
#pragma unroll
  for (int c = 0; c < ON; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // (K_j, V_j): landed for every thread; every warp is done with the slot
    // that the copy of tile j + NSLOT - 1 now overwrites
    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(j + NSLOT - 1);
    const uint32_t slot = j % NSLOT * SLOT_BYTES;

    float s[SN][4];
    float dp[SN][4];
#pragma unroll
    for (int c = 0; c < SN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 16 >= d) continue;  // columns past d rounded up to 16 are not loaded
      uint32_t aq[4], ao[4];
      ldm3d::ldmatrix_x4(aq, q_addr + kk * 16 * sizeof(bf16));
      ldm3d::ldmatrix_x4(ao, do_addr + kk * 16 * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < SN; c += 2) {
        const uint32_t off = slot + (c * 8 * LD + kk * 16) * sizeof(bf16);
        uint32_t bk[4], bv[4];
        ldm3d::ldmatrix_x4(bk, kn_addr + off);
        ldm3d::ldmatrix_x4(bv, kn_addr + V_BYTES + off);
        ldm3d::mma_bf16_16816(s[c], aq, bk[0], bk[1]);
        ldm3d::mma_bf16_16816(s[c + 1], aq, bk[2], bk[3]);
        ldm3d::mma_bf16_16816(dp[c], ao, bv[0], bv[1]);
        ldm3d::mma_bf16_16816(dp[c + 1], ao, bv[2], bv[3]);
      }
    }

    // dS = P * (dP - D) in place of S; P = 0 for keys past kv_len
    const int kv0 = j * BN;
    const bool ragged = kv0 + BN > kv_len;
#pragma unroll
    for (int c = 0; c < SN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[c][e], scale_log2, nl[e / 2]));
        if (ragged && kv0 + c * 8 + 2 * t + (e & 1) >= kv_len) p = 0.f;
        s[c][e] = p * (dp[c][e] - dd[e / 2]);
      }

    // dQ += dS K over each 16 keys: n-tile 2kk of dS fills A registers 0
    // and 1, n-tile 2kk + 1 registers 2 and 3; hi and lo on one B fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if (kv0 + kk * 16 >= kv_len) continue;  // all 16 keys past the edge: dS = 0
      uint32_t hi[4], lo[4];
      ldm3d::pack_bf16_split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      ldm3d::pack_bf16_split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      ldm3d::pack_bf16_split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      ldm3d::pack_bf16_split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int c = 0; c < ON; c += 2) {
        if (c * 8 >= d) continue;
        uint32_t bk[4];
        ldm3d::ldmatrix_x4_trans(bk, kt_addr + slot + (kk * 16 * LD + c * 8) * sizeof(bf16));
        ldm3d::mma_bf16_16816(acc[c], hi, bk[0], bk[1]);
        ldm3d::mma_bf16_16816(acc[c + 1], hi, bk[2], bk[3]);
        ldm3d::mma_bf16_16816(acc[c], lo, bk[0], bk[1]);
        ldm3d::mma_bf16_16816(acc[c + 1], lo, bk[2], bk[3]);
      }
    }
  }

  // scale * acc through the warp's own 16 rows of the Q tile (only this
  // warp reads them)
  store_rows<ON, LD>(acc, scale, qs + warp * 16 * LD, dq, b, h, H, n, row0 + warp * 16, n, d,
                     0);
}

// dK and dV. Grid (batch * heads * ceil(kv_len / BN), ceil(d / DOUT)). The Q
// and dO tiles, with their LSE and D, stream through a ring of SLOTS slots.
// The accumulators of S^T, dP^T, dK and dV take BM + DOUT fp32 registers a
// thread: 96 at DMAX = 64, two blocks an SM; 160 above, one block.
template <int DMAX>
__global__ void __launch_bounds__(MMA_NT, DMAX <= 64 ? 2 : 1) flash_bwd_dkv_bf16_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int n, int kv_len, int d, Strides st,
    float scale, float scale_log2) {
  using T = DkvMma<DMAX>;
  constexpr int BN = T::BN;
  constexpr int BM = T::BM;
  constexpr int NSLOT = T::SLOTS;
  constexpr int LD = T::LD;
  constexpr int KS = DMAX / 16;    // k-steps of K Q^T and V dO^T over the head dim
  constexpr int SN = BM / 8;       // 8-query n-tiles of S^T and dP^T
  constexpr int ON = T::DOUT / 8;  // 8-column n-tiles of dK and dV
  static_assert(BM % 16 == 0 && DMAX % 16 == 0 && NSLOT >= 2, "tiles are whole mma steps");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // BN x LD
  bf16* vs = ks + BN * LD;                       // BN x LD
  unsigned char* slots = smem_raw + 2 * BN * LD * sizeof(bf16);
  // slot i: Q tile, dO tile (BM x LD each), LSE, D (BM floats each)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // C rows (keys) g and g + 8
  const int t = lane % 4;  // C columns (queries) 2t and 2t + 1
  const int k_tiles = (kv_len + BN - 1) / BN;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int key0 = (blockIdx.x - bh * k_tiles) * BN;
  const int col0 = blockIdx.y * T::DOUT;
  const int n_tiles = (n + BM - 1) / BM;

  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  const bf16* ob = dout + b * st.o_sb + h * st.o_sh;
  const float* lb = lse + (int64_t)bh * n;
  const float* db = dvec + (int64_t)bh * n;

  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* slot = slots + i % NSLOT * T::SLOT;
      bf16* qt = reinterpret_cast<bf16*>(slot);
      float* lt = reinterpret_cast<float*>(slot + 2 * T::TILE);
      load_rows_async<BM, LD, DMAX>(qt, qb, st.q_sn, i * BM, n, d);
      load_rows_async<BM, LD, DMAX>(qt + BM * LD, ob, st.o_sn, i * BM, n, d);
      load_vec_async<BM>(lt, lb, i * BM, n);
      load_vec_async<BM>(lt + BM, db, i * BM, n);
    }
    ldm3d::cp_async_commit();
  };
  load_rows_async<BN, LD, DMAX>(ks, kb, st.k_sn, key0, kv_len, d);  // with tile 0
  load_rows_async<BN, LD, DMAX>(vs, vb, st.v_sn, key0, kv_len, d);
#pragma unroll
  for (int i = 0; i < NSLOT - 1; ++i) issue(i);

  // K, V (A): rows lane % 16 of the warp's 16 keys, column half lane / 16;
  // Q, dO (B of S^T and dP^T, two n-tiles): queries lane % 8 + 8 * (lane /
  // 16), dim half (lane / 8) % 2; Q, dO (B of dS^T Q and P^T dO via .trans,
  // two n-tiles): queries lane % 16, dim half lane / 16, from column col0.
  const uint32_t k_addr = ldm3d::smem_u32(ks + (warp * 16 + lane % 16) * LD + lane / 16 * 8);
  const uint32_t v_addr = ldm3d::smem_u32(vs + (warp * 16 + lane % 16) * LD + lane / 16 * 8);
  const uint32_t slot0 = ldm3d::smem_u32(slots);
  const uint32_t qn_off = ((lane % 8 + lane / 16 * 8) * LD + (lane / 8) % 2 * 8) * sizeof(bf16);
  const uint32_t qt_off = (lane % 16 * LD + lane / 16 * 8 + col0) * sizeof(bf16);
  constexpr uint32_t DO_BYTES = T::TILE;  // the dO tile after the Q tile

  float acc_k[ON][4];
  float acc_v[ON][4];
#pragma unroll
  for (int c = 0; c < ON; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(i + NSLOT - 1);
    const uint32_t slot = slot0 + i % NSLOT * T::SLOT;
    const float* lt = reinterpret_cast<const float*>(slots + i % NSLOT * T::SLOT + 2 * T::TILE);

    float s[SN][4];
    float dp[SN][4];
#pragma unroll
    for (int c = 0; c < SN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 16 >= d) continue;
      uint32_t ak[4], av[4];
      ldm3d::ldmatrix_x4(ak, k_addr + kk * 16 * sizeof(bf16));
      ldm3d::ldmatrix_x4(av, v_addr + kk * 16 * sizeof(bf16));
#pragma unroll
      for (int c = 0; c < SN; c += 2) {
        const uint32_t off = slot + qn_off + (c * 8 * LD + kk * 16) * sizeof(bf16);
        uint32_t bq[4], bo[4];
        ldm3d::ldmatrix_x4(bq, off);
        ldm3d::ldmatrix_x4(bo, off + DO_BYTES);
        ldm3d::mma_bf16_16816(s[c], ak, bq[0], bq[1]);
        ldm3d::mma_bf16_16816(s[c + 1], ak, bq[2], bq[3]);
        ldm3d::mma_bf16_16816(dp[c], av, bo[0], bo[1]);
        ldm3d::mma_bf16_16816(dp[c + 1], av, bo[2], bo[3]);
      }
    }

    // P^T in place of S^T, dS^T = P^T * (dP^T - D) in place of dP^T; a
    // column is a query: its LSE and D from the slot; P = 0 past n
    const int q0 = i * BM;
    const bool ragged = q0 + BM > n;
#pragma unroll
    for (int c = 0; c < SN; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(lt + BM + c * 8 + 2 * t);
      const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[c][e], scale_log2, nl[e & 1]));
        if (ragged && q0 + c * 8 + 2 * t + (e & 1) >= n) p = 0.f;
        s[c][e] = p;
        dp[c][e] = p * (dp[c][e] - dd[e & 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over each 16 queries, hi and lo
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      if (q0 + kk * 16 >= n) continue;  // all 16 queries past the edge: P = dS = 0
      uint32_t ph[4], pl[4], sh[4], sl[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 2 * kk + half;
        ldm3d::pack_bf16_split(s[c][0], s[c][1], ph[2 * half], pl[2 * half]);
        ldm3d::pack_bf16_split(s[c][2], s[c][3], ph[2 * half + 1], pl[2 * half + 1]);
        ldm3d::pack_bf16_split(dp[c][0], dp[c][1], sh[2 * half], sl[2 * half]);
        ldm3d::pack_bf16_split(dp[c][2], dp[c][3], sh[2 * half + 1], sl[2 * half + 1]);
      }
#pragma unroll
      for (int c = 0; c < ON; c += 2) {
        if (col0 + c * 8 >= d) continue;
        const uint32_t off = slot + qt_off + (kk * 16 * LD + c * 8) * sizeof(bf16);
        uint32_t bq[4], bo[4];
        ldm3d::ldmatrix_x4_trans(bo, off + DO_BYTES);
        ldm3d::ldmatrix_x4_trans(bq, off);
        ldm3d::mma_bf16_16816(acc_v[c], ph, bo[0], bo[1]);
        ldm3d::mma_bf16_16816(acc_v[c + 1], ph, bo[2], bo[3]);
        ldm3d::mma_bf16_16816(acc_k[c], sh, bq[0], bq[1]);
        ldm3d::mma_bf16_16816(acc_k[c + 1], sh, bq[2], bq[3]);
        ldm3d::mma_bf16_16816(acc_v[c], pl, bo[0], bo[1]);
        ldm3d::mma_bf16_16816(acc_v[c + 1], pl, bo[2], bo[3]);
        ldm3d::mma_bf16_16816(acc_k[c], sl, bq[0], bq[1]);
        ldm3d::mma_bf16_16816(acc_k[c + 1], sl, bq[2], bq[3]);
      }
    }
  }

  // dK = scale * acc_k and dV through the warp's own 16 rows of the K and V
  // tiles (only this warp reads them)
  const int key_w = key0 + warp * 16;
  store_rows<ON, LD>(acc_k, scale, ks + warp * 16 * LD, dk, b, h, H, kv_len, key_w, kv_len, d,
                     col0);
  store_rows<ON, LD>(acc_v, 1.f, vs + warp * 16 * LD, dv, b, h, H, kv_len, key_w, kv_len, d,
                     col0);
}

template <int DMAX>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dvec, void* dq, int B, int H, int n,
                           int kv_len, int d, const Strides& st, float scale,
                           cudaStream_t stream) {
  using T = DqMma<DMAX>;
  static_assert(T::SMEM <= MAX_SMEM, "dQ tiles exceed a block's shared memory");
  auto kernel = flash_bwd_dq_bf16_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, T::SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + T::BM - 1) / T::BM * (int64_t)B * H));
  kernel<<<grid, MMA_NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<bf16*>(dq), H, n, kv_len, d, st, scale,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* dk, void* dv, int B, int H,
                            int n, int kv_len, int d, const Strides& st, float scale,
                            cudaStream_t stream) {
  using T = DkvMma<DMAX>;
  static_assert(T::SMEM <= MAX_SMEM, "dK/dV tiles exceed a block's shared memory");
  auto kernel = flash_bwd_dkv_bf16_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, T::SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((kv_len + T::BN - 1) / T::BN * (int64_t)B * H),
                  (d + T::DOUT - 1) / T::DOUT);
  kernel<<<grid, MMA_NT, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, n,
      kv_len, d, st, scale, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;  // threads per block

// Copy rows [row0, row0 + rows) of one (batch, head) slice into shared memory
// with pitch d+1, times `mul`; rows past `valid` are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t row_stride, int row0, int rows, int valid,
                                          int d, float mul) {
  const int ld = d + 1;
  for (int i = threadIdx.x; i < rows * d; i += NT) {
    const int r = i / d;
    const int c = i - r * d;
    const int t = row0 + r;
    dst[r * ld + c] = t < valid ? src[(int64_t)t * row_stride + c] * mul : 0.f;
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

template <int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dq_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, float* __restrict__ dq, int H, int n, int kv_len, int d,
    Strides st, float scale) {
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
  const int q_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * q_tiles) * BM;

  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  const float* ob = dout + b * st.o_sb + h * st.o_sh;

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
    float* out = dq + ((int64_t)(b * n + t) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = tx + TX * c;
      if (col < d) out[col] = scale * acc[i][c];
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, float* __restrict__ dk, float* __restrict__ dv, int H,
    int n, int kv_len, int d, Strides st, float scale) {
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
  const int k_tiles = (kv_len + BN - 1) / BN;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int key0 = (blockIdx.x - bh * k_tiles) * BN;

  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  const float* ob = dout + b * st.o_sb + h * st.o_sh;

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
        dk[base + col] = acc_k[i][c];  // q was pre-scaled: dK = scale * dS^T Q
        dv[base + col] = acc_v[i][c];
      }
    }
  }
}

template <int DMAX>
cudaError_t launch_dq_fp32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dvec, void* dq, int B, int H, int n,
                           int kv_len, int d, const Strides& st, float scale,
                           cudaStream_t stream) {
  constexpr int BM = DqTiles<DMAX>::BM;
  constexpr int BN = DqTiles<DMAX>::BN;
  static_assert(dq_smem_bytes(DMAX, BM, BN) <= MAX_SMEM, "dQ tiles exceed a block's shared memory");
  const size_t smem = dq_smem_bytes(d, BM, BN);
  if (smem > dq_smem_bytes(DMAX, BM, BN)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_fp32_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, dq_smem_bytes(DMAX, BM, BN), opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + BM - 1) / BM * (int64_t)B * H));
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<float*>(dq), H, n, kv_len, d, st, scale);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_fp32(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* dk, void* dv, int B, int H,
                            int n, int kv_len, int d, const Strides& st, float scale,
                            cudaStream_t stream) {
  constexpr int BM = DkvTiles<DMAX>::BM;
  constexpr int BN = DkvTiles<DMAX>::BN;
  static_assert(dkv_smem_bytes(DMAX, BM, BN) <= MAX_SMEM,
                "dK/dV tiles exceed a block's shared memory");
  const size_t smem = dkv_smem_bytes(d, BM, BN);
  if (smem > dkv_smem_bytes(DMAX, BM, BN)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_fp32_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, dkv_smem_bytes(DMAX, BM, BN), opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((kv_len + BN - 1) / BN * (int64_t)B * H));
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<float*>(dk), static_cast<float*>(dv), H, n,
      kv_len, d, st, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head_dim > 256, either dtype: scalar FMA, the output's head dims over grid.y

constexpr int W_T = 16;     // the block is W_T x W_T threads
constexpr int W_NT = W_T * W_T;
constexpr int W_DC = 16;    // head dims per chunk of S and dP

// dQ, d > 256. Grid (batch * heads * ceil(n / BM), ceil(d / DOUT)). Each
// block owns BM query rows and DOUT head dims of dQ; for each tile of BN keys
// it recomputes S and dP over the whole d, streaming W_DC-dim chunks of Q,
// dO, K and V through shared memory, puts dS in shared memory and adds
// dS K for its DOUT columns. Thread (ty, tx) owns rows ty + 16i, keys
// tx + 16j and head dims tx + 16c.
template <typename T>
__global__ void __launch_bounds__(W_NT) flash_bwd_dq_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dq, int H, int n, int kv_len, int d, Strides st, float scale) {
  constexpr int BM = 64, BN = 32, DOUT = 128;
  constexpr int RM = BM / W_T, RN = BN / W_T, RD = DOUT / W_T;
  __shared__ float qc[BM][W_DC + 1];
  __shared__ float oc[BM][W_DC + 1];
  __shared__ float kc[BN][W_DC + 1];
  __shared__ float vc[BN][W_DC + 1];
  __shared__ float dss[BM][BN + 1];
  __shared__ float kt[BN][DOUT + 1];

  const int tx = threadIdx.x % W_T;
  const int ty = threadIdx.x / W_T;
  const int q_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * q_tiles) * BM;
  const int col0 = blockIdx.y * DOUT;
  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const T* ob = dout + b * st.o_sb + h * st.o_sh;

  float row_lse[RM], row_d[RM], acc[RM][RD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + W_T * i;
    row_lse[i] = row < n ? lse[(int64_t)bh * n + row] : 0.f;
    row_d[i] = row < n ? dvec[(int64_t)bh * n + row] : 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += BN) {
    float s[RM][RN], dp[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += W_DC) {
      __syncthreads();  // the previous chunk, dS and the K tile are no longer read
      ldm3d::load_chunk<BM, W_DC, W_NT>(qc, qb, st.q_sn, row0, n, c0, d);
      ldm3d::load_chunk<BM, W_DC, W_NT>(oc, ob, st.o_sn, row0, n, c0, d);
      ldm3d::load_chunk<BN, W_DC, W_NT>(kc, kb, st.k_sn, kv0, kv_len, c0, d);
      ldm3d::load_chunk<BN, W_DC, W_NT>(vc, vb, st.v_sn, kv0, kv_len, c0, d);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < W_DC; ++c) {
        float qv[RM], ov[RM], kv[RN], vv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          qv[i] = qc[ty + W_T * i][c];
          ov[i] = oc[ty + W_T * i][c];
        }
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          kv[j] = kc[tx + W_T * j][c];
          vv[j] = vc[tx + W_T * j][c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const bool row_ok = row0 + ty + W_T * i < n;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const bool key_ok = kv0 + tx + W_T * j < kv_len;
        const float p = row_ok && key_ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dss[ty + W_T * i][tx + W_T * j] = p * (dp[i][j] - row_d[i]);
      }
    }
    ldm3d::load_chunk<BN, DOUT, W_NT>(kt, kb, st.k_sn, kv0, kv_len, col0, d);
    __syncthreads();  // dS and the K tile are visible

    const int nk = min(BN, kv_len - kv0);
    for (int kk = 0; kk < nk; ++kk) {
      float ds[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = dss[ty + W_T * i][kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const float kval = kt[kk][tx + W_T * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(ds[i], kval, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + W_T * i;
    if (row >= n) continue;
    T* out = dq + ((int64_t)(b * n + row) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = col0 + tx + W_T * c;
      if (col < d) ldm3d::store(out + col, scale * acc[i][c]);
    }
  }
}

// dK and dV, d > 256. Grid (batch * heads * ceil(kv_len / BN), ceil(d /
// DOUT)). Each block owns BN keys and DOUT head dims of dK and dV; for each
// tile of BM queries it recomputes S^T and dP^T over the whole d in W_DC-dim
// chunks, puts P^T and dS^T in shared memory and adds P^T dO and dS^T Q for
// its DOUT columns. Thread (ty, tx) owns keys ty + 16i, queries tx + 16j and
// head dims tx + 16c.
template <typename T>
__global__ void __launch_bounds__(W_NT) flash_bwd_dkv_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ dvec,
    T* __restrict__ dk, T* __restrict__ dv, int H, int n, int kv_len, int d, Strides st,
    float scale) {
  constexpr int BN = 32, BM = 32, DOUT = 64;
  constexpr int RK = BN / W_T, RQ = BM / W_T, RD = DOUT / W_T;
  __shared__ float kc[BN][W_DC + 1];
  __shared__ float vc[BN][W_DC + 1];
  __shared__ float qc[BM][W_DC + 1];
  __shared__ float oc[BM][W_DC + 1];
  __shared__ float pt[BN][BM + 1];
  __shared__ float dst[BN][BM + 1];
  __shared__ float qt[BM][DOUT + 1];
  __shared__ float ot[BM][DOUT + 1];
  __shared__ float lse_s[BM];
  __shared__ float d_s[BM];

  const int tx = threadIdx.x % W_T;
  const int ty = threadIdx.x / W_T;
  const int k_tiles = (kv_len + BN - 1) / BN;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int key0 = (blockIdx.x - bh * k_tiles) * BN;
  const int col0 = blockIdx.y * DOUT;
  const T* qb = q + b * st.q_sb + h * st.q_sh;
  const T* kb = k + b * st.k_sb + h * st.k_sh;
  const T* vb = v + b * st.v_sb + h * st.v_sh;
  const T* ob = dout + b * st.o_sb + h * st.o_sh;

  float acc_k[RK][RD], acc_v[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < RD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BM) {
    float s[RK][RQ], dp[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += W_DC) {
      __syncthreads();  // the previous chunk, P^T, dS^T, LSE, D and the Q, dO tiles are no longer read
      if (c0 == 0)
        for (int r = threadIdx.x; r < BM; r += W_NT) {
          const bool ok = q0 + r < n;
          lse_s[r] = ok ? lse[(int64_t)bh * n + q0 + r] : 0.f;
          d_s[r] = ok ? dvec[(int64_t)bh * n + q0 + r] : 0.f;
        }
      ldm3d::load_chunk<BN, W_DC, W_NT>(kc, kb, st.k_sn, key0, kv_len, c0, d);
      ldm3d::load_chunk<BN, W_DC, W_NT>(vc, vb, st.v_sn, key0, kv_len, c0, d);
      ldm3d::load_chunk<BM, W_DC, W_NT>(qc, qb, st.q_sn, q0, n, c0, d);
      ldm3d::load_chunk<BM, W_DC, W_NT>(oc, ob, st.o_sn, q0, n, c0, d);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < W_DC; ++c) {
        float kv[RK], vv[RK], qv[RQ], ov[RQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = kc[ty + W_T * i][c];
          vv[i] = vc[ty + W_T * i][c];
        }
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          qv[j] = qc[tx + W_T * j][c];
          ov[j] = oc[tx + W_T * j][c];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < RQ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const bool key_ok = key0 + ty + W_T * i < kv_len;
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int r = tx + W_T * j;
        const float p = key_ok && q0 + r < n ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        pt[ty + W_T * i][r] = p;
        dst[ty + W_T * i][r] = p * (dp[i][j] - d_s[r]);
      }
    }
    ldm3d::load_chunk<BM, DOUT, W_NT>(qt, qb, st.q_sn, q0, n, col0, d);
    ldm3d::load_chunk<BM, DOUT, W_NT>(ot, ob, st.o_sn, q0, n, col0, d);
    __syncthreads();  // P^T, dS^T and the Q, dO tiles are visible

    const int nq = min(BM, n - q0);
    for (int qq = 0; qq < nq; ++qq) {
      float pv[RK], dsv[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = pt[ty + W_T * i][qq];
        dsv[i] = dst[ty + W_T * i][qq];
      }
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const float ov = ot[qq][tx + W_T * c];
        const float qv = qt[qq][tx + W_T * c];
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
    const int key = key0 + ty + W_T * i;
    if (key >= kv_len) continue;
    const int64_t base = ((int64_t)(b * kv_len + key) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = col0 + tx + W_T * c;
      if (col < d) {
        ldm3d::store(dk + base + col, scale * acc_k[i][c]);
        ldm3d::store(dv + base + col, acc_v[i][c]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dvec, void* dq, int B, int H, int n,
                           int kv_len, int d, const Strides& st, float scale,
                           cudaStream_t stream) {
  const dim3 grid((unsigned)((n + 63) / 64 * (int64_t)B * H), (d + 127) / 128);
  flash_bwd_dq_wide_kernel<T><<<grid, W_NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dq), H, n, kv_len, d, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* dk, void* dv, int B, int H,
                            int n, int kv_len, int d, const Strides& st, float scale,
                            cudaStream_t stream) {
  const dim3 grid((unsigned)((kv_len + 31) / 32 * (int64_t)B * H), (d + 63) / 64);
  flash_bwd_dkv_wide_kernel<T><<<grid, W_NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk), static_cast<T*>(dv), H, n, kv_len,
      d, st, scale);
  return cudaGetLastError();
}

// d a multiple of 8 (the wrapper pads other widths), and a grid of at most
// 2^31 - 1 blocks (the smallest tiles, 32 rows, bound it)
bool bad_shape(int B, int H, int n, int kv_len, int d) {
  return B <= 0 || H <= 0 || n <= 0 || kv_len <= 0 || d <= 0 || d % 8 != 0 ||
         (int64_t)B * H * ((n > kv_len ? n : kv_len) + 31) / 32 > INT32_MAX;
}

Strides to_strides(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// q, dO: (B, n, H, d); k, v: (B, kv_len, H, d); each with unit stride on d,
// and in bf16 with base pointers and strides on 16 bytes; d a multiple of 8,
// any B * H. Routes: d <= 256 by dtype, the tensor-core or the scalar fp32
// kernel; d > 256 the wide kernel of either dtype.
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
#define LDM3D_DQ(R, D) launch_dq_##R<D>(q, k, v, dout, lse, dvec, dq, B, H, n, kv_len, d, st, scale, s)
  if (d > 256) return (int)(is_bf16 ? LDM3D_DQ(wide, bf16) : LDM3D_DQ(wide, float));
  if (is_bf16) {
    if (d <= 64) return (int)LDM3D_DQ(bf16, 64);
    if (d <= 128) return (int)LDM3D_DQ(bf16, 128);
    return (int)LDM3D_DQ(bf16, 256);
  }
  if (d <= 64) return (int)LDM3D_DQ(fp32, 64);
  if (d <= 128) return (int)LDM3D_DQ(fp32, 128);
  return (int)LDM3D_DQ(fp32, 256);
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
#define LDM3D_DKV(R, D) \
  launch_dkv_##R<D>(q, k, v, dout, lse, dvec, dk, dv, B, H, n, kv_len, d, st, scale, s)
  if (d > 256) return (int)(is_bf16 ? LDM3D_DKV(wide, bf16) : LDM3D_DKV(wide, float));
  if (is_bf16) {
    if (d <= 64) return (int)LDM3D_DKV(bf16, 64);
    if (d <= 128) return (int)LDM3D_DKV(bf16, 128);
    return (int)LDM3D_DKV(bf16, 256);
  }
  if (d <= 64) return (int)LDM3D_DKV(fp32, 64);
  if (d <= 128) return (int)LDM3D_DKV(fp32, 128);
  return (int)LDM3D_DKV(fp32, 256);
#undef LDM3D_DKV
}
