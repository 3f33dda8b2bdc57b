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
// flagship's d = 64 and n = 1000 both are bound by the tensor cores: in bf16
// at 989 TFLOP/s, in fp32 at the 495 TFLOP/s of TF32 over the three products
// of the split; the 125-token level is bound by its bytes in bf16.
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
// * fp32, d <= 256: flash_bwd_dq_tf32x3_mma_kernel and
//   flash_bwd_dkv_tf32x3_mma_kernel, the same two FlashAttention-2 backward
//   kernels on mma.sync m16n8k8 with tf32 operands and fp32 accumulators,
//   each operand split in registers into hi = tf32(x) and lo = tf32(x - hi)
//   and each product three mma (lo*hi + hi*lo + hi*hi, split_tf32 and
//   mma_tf32x3 in mma_sm90.cuh): one tf32 rounding of each operand would put
//   the gradients 3-10x past the fp32 limit of 1e-4 of the largest |grad|
//   (emulated on the CPU in tests/test_torch_attention_grad.py).
//   - dQ: 8 warps of 16 query rows (4 at DMAX = 256); Q and dO resident, K
//     and V tiles of 32 keys (16 at DMAX = 256) through a two-slot cp.async
//     ring. dK/dV: 8 warps of 16 keys (4 at DMAX = 256, where a grid axis
//     gives each block 128 of the head dims of dK and dV); K and V resident,
//     Q, dO, LSE and D tiles of 16 queries through the ring.
//   - TF32 has no ldmatrix (a b16 instruction): fragments are 32- and 64-bit
//     loads from shared memory, and each tile's row pitch follows its reads
//     (the DqTf32 / DkvTf32 notes): DMAX + 4 floats for a tile read both
//     along head dims and along keys or queries, DMAX + 8 for one read as
//     float2 pairs along head dims only.
//   - the C -> A fragment mapping: P, dS, P^T and dS^T stay in the
//     accumulator registers of S, dP, S^T and dP^T and feed the next product
//     as a0..a3 = c0, c2, c1, c3, so the B rows (keys of K for dS K, queries
//     of dO and Q for P^T dO and dS^T Q) are loaded as 2t, 2t + 1
//     (acc_tile_tf32x3; the CPU test pins each mapping).
//   - the three mma of a product wait on one accumulator, so G n-tiles are
//     taken together, their lo*hi first; and each tile's dQ, dK, dV products
//     go to a zeroed partial added to the fp32 accumulator once, to nearest:
//     the tensor cores truncate each mma's sum, which over thousands of
//     chained mma took dQ to 0.76 of the fp32 limit at 8000 keys (emulated
//     with and without the partials in tests/test_torch_attention_grad.py).
//   - scale as the bf16 route: q is not pre-scaled, P = exp2 of one fma on S
//     with the LSE, dQ and dK times the scale once at the store; rows copied
//     in 16-byte pieces, or 4-byte ones for views off 16 bytes.
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
// piece (a row of n floats starts on 16 bytes only when 4 divides n), by the
// NT threads of the block.
template <int ROWS, int NT = MMA_NT>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src,
                                               int row0, int valid) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
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
// fp32: TF32 tensor cores, 3xTF32

// Tiles of the fp32 route. Rows of a tile in shared memory have one of two
// pitches, chosen by how the fragments read them (32- and 64-bit loads:
// ldmatrix is a b16 instruction, so TF32 has none):
// - DMAX + 4 floats (4 mod 32) for a tile read as scalars at rows g and
//   columns t, t + 4 (banks 4g + t) and at rows 2t, 2t + 1 and column g
//   (banks 8t + g, 8t + 4 + g): each 32-bit load of a warp hits 32 banks;
// - DMAX + 8 floats (8 mod 32) for a tile read as float2 at rows g and
//   columns 2t, 2t + 1 only: each half-warp's 64-bit load hits 32 banks.
// dQ: BM query rows a block (16 a warp), BN keys a K or V tile, SLOTS (K, V)
// tile pairs in the ring. Q and K are read both ways (K also along keys, as
// the B operand of dS K): pitch LDA; dO and V only along head dims: LDB.
template <int DMAX>
struct DqTf32 {
  static constexpr int WARPS = DMAX > 128 ? 4 : 8;
  static constexpr int NT = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;
  static constexpr int BN = DMAX > 128 ? 16 : 32;
  static constexpr int SLOTS = 2;
  static constexpr int LDA = DMAX + 4;
  static constexpr int LDB = DMAX + 8;
  static constexpr int SLOT = BN * (LDA + LDB);  // floats of a (K, V) slot
  static constexpr size_t SMEM = ((size_t)BM * (LDA + LDB) + (size_t)SLOTS * SLOT) * sizeof(float);
};

// dK/dV: BN keys a block (16 a warp), DOUT head-dim columns of dK and dV a
// block, BM queries a Q or dO tile, SLOTS (Q, dO, LSE, D) tiles in the ring.
// Q and dO are read both ways (along queries as the B operands of P^T dO
// and dS^T Q): every tile at pitch LD. At DMAX = 256 the K and V of 128 keys
// would not fit a block's shared memory: 4 warps own 64 keys.
template <int DMAX>
struct DkvTf32 {
  static constexpr int WARPS = DMAX > 128 ? 4 : 8;
  static constexpr int NT = 32 * WARPS;
  static constexpr int BN = 16 * WARPS;
  static constexpr int DOUT = DMAX > 128 ? 128 : DMAX;
  static constexpr int BM = DMAX <= 64 ? 32 : 16;
  static constexpr int SLOTS = DMAX > 128 ? 2 : 3;
  static constexpr int LD = DMAX + 4;
  static constexpr int SLOT = 2 * BM * LD + 2 * BM;  // floats: Q, dO tiles, LSE, D
  static constexpr size_t SMEM = ((size_t)2 * BN * LD + (size_t)SLOTS * SLOT) * sizeof(float);
};

// acc[c0 .. c0 + G) += A B over the K8 k-steps of a tile (the first `steps`
// of them), in 3xTF32. A (16 x 8 K8) stays in the accumulator registers of
// the product that made it: for the 8 columns of n-tile kk, a0, a1, a2,
// a3 = c0, c2, c1, c3, so k index t stands for column 8kk + 2t and t + 4
// for 8kk + 2t + 1, and B's fragment is loaded in that order from the tile
// `b` (pitch LD): b0 = b[8kk + 2t][8c + g], b1 = b[8kk + 2t + 1][8c + g].
// The tile's products go to a zeroed partial, added to acc in fp32 (round to
// nearest) once: the tensor cores truncate each mma's sum, and in a chain of
// thousands of mma on one accumulator the truncations add up to most of the
// fp32 limit (dQ over 8000 keys: 0.75 of it at d = 64 and 0.92 at d = 256 in
// the CPU emulation of tests/test_torch_attention_grad.py, 0.76 measured on
// the card at d = 256); in a tile's partial they do not (0.02 and 0.07).
template <int G, int K8, int LD, int N>
__device__ __forceinline__ void acc_tile_tf32x3(float (&acc)[N][4], int c0, const float (&a)[K8][4],
                                                const float* b, int steps) {
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  float part[G][4] = {};
#pragma unroll
  for (int kk = 0; kk < K8; ++kk) {
    if (kk >= steps) continue;
    uint32_t ah[4], al[4], bh[G][2], bl[G][2];
    ldm3d::split_tf32_a(a[kk][0], a[kk][2], a[kk][1], a[kk][3], ah, al);
    const float* br = b + (kk * 8 + 2 * t) * LD + c0 * 8 + g;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      ldm3d::split_tf32(br[j * 8], bh[j][0], bl[j][0]);
      ldm3d::split_tf32(br[LD + j * 8], bh[j][1], bl[j][1]);
    }
    ldm3d::mma_tf32x3<G>(part, ah, al, bh, bl);
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c0 + j][e] += part[j][e];
}

// acc_tile_tf32x3 for two products on the same k-steps at once (dV from P^T
// and dO, dK from dS^T and Q), their mma interleaved (mma_tf32x3_2).
template <int G, int K8, int LD, int N>
__device__ __forceinline__ void acc_tile_tf32x3_2(float (&acc)[N][4], const float (&a)[K8][4],
                                                  const float* b, float (&acc2)[N][4],
                                                  const float (&a2)[K8][4], const float* b2,
                                                  int c0, int steps) {
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  float part[G][4] = {};
  float part2[G][4] = {};
#pragma unroll
  for (int kk = 0; kk < K8; ++kk) {
    if (kk >= steps) continue;
    uint32_t ah[4], al[4], bh[G][2], bl[G][2], ah2[4], al2[4], bh2[G][2], bl2[G][2];
    ldm3d::split_tf32_a(a[kk][0], a[kk][2], a[kk][1], a[kk][3], ah, al);
    ldm3d::split_tf32_a(a2[kk][0], a2[kk][2], a2[kk][1], a2[kk][3], ah2, al2);
    const int row = (kk * 8 + 2 * t) * LD + c0 * 8 + g;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      ldm3d::split_tf32(b[row + j * 8], bh[j][0], bl[j][0]);
      ldm3d::split_tf32(b[row + LD + j * 8], bh[j][1], bl[j][1]);
      ldm3d::split_tf32(b2[row + j * 8], bh2[j][0], bl2[j][0]);
      ldm3d::split_tf32(b2[row + LD + j * 8], bh2[j][1], bl2[j][1]);
    }
    ldm3d::mma_tf32x3_2<G>(part, ah, al, bh, bl, part2, ah2, al2, bh2, bl2);
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[c0 + j][e] += part[j][e];
      acc2[c0 + j][e] += part2[j][e];
    }
}

// dQ. Grid (batch * heads * ceil(n / BM)). Q and dO stay in shared memory;
// the K and V tiles stream through a ring of SLOTS (K_j, V_j) pairs (the
// copy of the next pair in flight while one is multiplied). Every product is
// three mma.sync m16n8k8 on tf32 parts split in registers at each fragment
// load (split_tf32: lo*hi, hi*lo, hi*hi), GS or G n-tiles at a time.
// - S = Q K^T and dP = dO V^T, issued as interleaved pairs (mma_tf32x3_2).
//   In S, k index t stands for head dim 8kk + t, t + 4 for 8kk + t + 4
//   (scalar loads: K is also read along keys, below); in dP for 8kk + 2t
//   and 8kk + 2t + 1, so that a0/a2, a1/a3 and b0/b1 are each one float2.
// - dQ += dS K (acc_tile_tf32x3): dS stays in S's accumulator registers and
//   K's B fragment is loaded at keys 8kk + 2t, 8kk + 2t + 1
//   (tests/test_torch_attention_grad.py emulates the three mappings).
// The accumulators of S, dP and dQ take BN + DMAX / 2 fp32 registers a
// thread: 64 at DMAX = 64, two blocks an SM (128 registers, no spill); 96
// and 160 above, one block.
template <int DMAX>
__global__ void __launch_bounds__(DqTf32<DMAX>::NT, DMAX <= 64 ? 2 : 1)
    flash_bwd_dq_tf32x3_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ dout,
                                   const float* __restrict__ lse, const float* __restrict__ dvec,
                                   float* __restrict__ dq, int H, int n, int kv_len, int d,
                                   Strides st, float scale, float scale_log2, int vec16) {
  using T = DqTf32<DMAX>;
  constexpr int BM = T::BM;
  constexpr int BN = T::BN;
  constexpr int NSLOT = T::SLOTS;
  constexpr int LDA = T::LDA;
  constexpr int LDB = T::LDB;
  constexpr int KS = DMAX / 8;          // k-steps of Q K^T and dO V^T over the head dim
  constexpr int SN = BN / 8;            // 8-key n-tiles of S and dP, k-steps of dS K
  constexpr int ON = DMAX / 8;          // 8-column n-tiles of dQ
  constexpr int GS = SN < 4 ? SN : 4;   // n-tiles of S and dP taken together
  constexpr int G = 4;                  // n-tiles of dQ taken together
  static_assert(NSLOT >= 2 && SN % GS == 0 && ON % G == 0, "tiles are whole mma groups");
  extern __shared__ __align__(128) float smem_f[];
  float* qs = smem_f;             // BM x LDA
  float* dos = qs + BM * LDA;     // BM x LDB
  float* slots = dos + BM * LDB;  // NSLOT x (K tile BN x LDA, V tile BN x LDB)

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

  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  const float* ob = dout + b * st.o_sb + h * st.o_sh;

  auto issue = [&](int j) {
    if (j < n_tiles) {
      float* slot = slots + j % NSLOT * T::SLOT;
      ldm3d::load_rows_f32<BN, LDA, DMAX, T::NT>(slot, kb, st.k_sn, j * BN, kv_len, d, vec16);
      ldm3d::load_rows_f32<BN, LDB, DMAX, T::NT>(slot + BN * LDA, vb, st.v_sn, j * BN, kv_len, d,
                                                 vec16);
    }
    ldm3d::cp_async_commit();
  };
  ldm3d::load_rows_f32<BM, LDA, DMAX, T::NT>(qs, qb, st.q_sn, row0, n, d, vec16);  // with tile 0
  ldm3d::load_rows_f32<BM, LDB, DMAX, T::NT>(dos, ob, st.o_sn, row0, n, d, vec16);
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

  const float* qa = qs + (warp * 16 + g) * LDA + t;       // A of S: rows g, g + 8; dims t, t + 4
  const float* oa = dos + (warp * 16 + g) * LDB + 2 * t;  // A of dP: dims 2t, 2t + 1

  float acc[ON][4];
#pragma unroll
  for (int c = 0; c < ON; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // (K_j, V_j): landed for every thread; every warp is done with the slot
    // that the copy of tile j + NSLOT - 1 now overwrites
    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(j + NSLOT - 1);
    const float* kt = slots + j % NSLOT * T::SLOT;
    const float* vt = kt + BN * LDA;

    float s[SN][4];
    float dp[SN][4];
#pragma unroll
    for (int c = 0; c < SN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 8 >= d) continue;  // head dims past d are not loaded
      uint32_t ah[4], al[4], oh[4], ol[4];
      ldm3d::split_tf32_a(qa[kk * 8], qa[8 * LDA + kk * 8], qa[kk * 8 + 4],
                          qa[8 * LDA + kk * 8 + 4], ah, al);
      const float2 o0 = *reinterpret_cast<const float2*>(oa + kk * 8);
      const float2 o1 = *reinterpret_cast<const float2*>(oa + 8 * LDB + kk * 8);
      ldm3d::split_tf32_a(o0.x, o1.x, o0.y, o1.y, oh, ol);
#pragma unroll
      for (int c0 = 0; c0 < SN; c0 += GS) {
        uint32_t bh[GS][2], bl[GS][2], vh[GS][2], vl[GS][2];
#pragma unroll
        for (int i = 0; i < GS; ++i) {
          const float* kr = kt + ((c0 + i) * 8 + g) * LDA + kk * 8 + t;
          ldm3d::split_tf32(kr[0], bh[i][0], bl[i][0]);
          ldm3d::split_tf32(kr[4], bh[i][1], bl[i][1]);
          const float2 vv =
              *reinterpret_cast<const float2*>(vt + ((c0 + i) * 8 + g) * LDB + kk * 8 + 2 * t);
          ldm3d::split_tf32(vv.x, vh[i][0], vl[i][0]);
          ldm3d::split_tf32(vv.y, vh[i][1], vl[i][1]);
        }
        ldm3d::mma_tf32x3_2<GS>(&s[c0], ah, al, bh, bl, &dp[c0], oh, ol, vh, vl);
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

    // dQ += dS K, G n-tiles at a time; k-steps of 8 keys all past the edge
    // (dS = 0) are skipped, n-tiles of a group past d computed, not stored
    const int steps = min(SN, (kv_len - kv0 + 7) / 8);
#pragma unroll
    for (int c0 = 0; c0 < ON; c0 += G)
      if (c0 * 8 < d) acc_tile_tf32x3<G, SN, LDA>(acc, c0, s, kt, steps);
  }

  // each lane stores columns 8c + 2t, 8c + 2t + 1 of its rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    float* orow = dq + ((int64_t)(b * n + row) * H + h) * d + 2 * t;
#pragma unroll
    for (int c = 0; c < ON; ++c)
      if (c * 8 < d)
        *reinterpret_cast<float2*>(orow + c * 8) =
            make_float2(acc[c][2 * r] * scale, acc[c][2 * r + 1] * scale);
  }
}

// dK and dV. Grid (batch * heads * ceil(kv_len / BN), ceil(d / DOUT)). K and
// V stay in shared memory; the Q and dO tiles, with their LSE and D, stream
// through a ring of SLOTS slots. As dQ, every product is 3xTF32:
// - S^T = K Q^T and dP^T = V dO^T, issued as interleaved pairs
//   (mma_tf32x3_2): k index t stands for head dim 8kk + t, t + 4 for
//   8kk + t + 4 (scalar loads: Q and dO are also read along queries).
// - dV += P^T dO and dK += dS^T Q, also as pairs (acc_tile_tf32x3_2): P^T
//   and dS^T stay in the accumulator registers of S^T and dP^T, and dO's and
//   Q's B fragments are loaded at queries 8kk + 2t, 8kk + 2t + 1.
// The accumulators of S^T, dP^T, dK and dV and the two partials take BM +
// DOUT + 32 fp32 registers a thread (128 at DMAX = 64), more than two
// blocks an SM allow without a spill: one block of 8 warps an SM, with
// 32-query tiles at DMAX = 64 (four n-tiles of S^T in each product, against
// two at 16; PERF.md).
template <int DMAX>
__global__ void __launch_bounds__(DkvTf32<DMAX>::NT, 1)
    flash_bwd_dkv_tf32x3_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ dout,
                                    const float* __restrict__ lse, const float* __restrict__ dvec,
                                    float* __restrict__ dk, float* __restrict__ dv, int H, int n,
                                    int kv_len, int d, Strides st, float scale, float scale_log2,
                                    int vec16) {
  using T = DkvTf32<DMAX>;
  constexpr int BN = T::BN;
  constexpr int BM = T::BM;
  constexpr int NSLOT = T::SLOTS;
  constexpr int LD = T::LD;
  constexpr int KS = DMAX / 8;          // k-steps of K Q^T and V dO^T over the head dim
  constexpr int SN = BM / 8;            // 8-query n-tiles of S^T and dP^T, k-steps of dV, dK
  constexpr int ON = T::DOUT / 8;       // 8-column n-tiles of dK and dV
  constexpr int GS = SN < 4 ? SN : 4;   // n-tiles of S^T and dP^T taken together
  constexpr int G = 4;                  // n-tiles of dK and dV taken together
  static_assert(NSLOT >= 2 && SN % GS == 0 && ON % G == 0, "tiles are whole mma groups");
  extern __shared__ __align__(128) float smem_f[];
  float* ks = smem_f;          // BN x LD
  float* vs = ks + BN * LD;    // BN x LD
  float* slots = vs + BN * LD;  // slot i: Q tile, dO tile (BM x LD each), LSE, D (BM each)

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

  const float* qb = q + b * st.q_sb + h * st.q_sh;
  const float* kb = k + b * st.k_sb + h * st.k_sh;
  const float* vb = v + b * st.v_sb + h * st.v_sh;
  const float* ob = dout + b * st.o_sb + h * st.o_sh;
  const float* lb = lse + (int64_t)bh * n;
  const float* db = dvec + (int64_t)bh * n;

  auto issue = [&](int i) {
    if (i < n_tiles) {
      float* slot = slots + i % NSLOT * T::SLOT;
      ldm3d::load_rows_f32<BM, LD, DMAX, T::NT>(slot, qb, st.q_sn, i * BM, n, d, vec16);
      ldm3d::load_rows_f32<BM, LD, DMAX, T::NT>(slot + BM * LD, ob, st.o_sn, i * BM, n, d,
                                                vec16);
      load_vec_async<BM, T::NT>(slot + 2 * BM * LD, lb, i * BM, n);
      load_vec_async<BM, T::NT>(slot + 2 * BM * LD + BM, db, i * BM, n);
    }
    ldm3d::cp_async_commit();
  };
  // with tile 0
  ldm3d::load_rows_f32<BN, LD, DMAX, T::NT>(ks, kb, st.k_sn, key0, kv_len, d, vec16);
  ldm3d::load_rows_f32<BN, LD, DMAX, T::NT>(vs, vb, st.v_sn, key0, kv_len, d, vec16);
#pragma unroll
  for (int i = 0; i < NSLOT - 1; ++i) issue(i);

  const float* ka = ks + (warp * 16 + g) * LD + t;  // A: keys g, g + 8; dims t, t + 4
  const float* va = vs + (warp * 16 + g) * LD + t;

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
    const float* qt = slots + i % NSLOT * T::SLOT;
    const float* ot = qt + BM * LD;
    const float* lt = ot + BM * LD;  // LSE, then D

    float s[SN][4];
    float dp[SN][4];
#pragma unroll
    for (int c = 0; c < SN; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 8 >= d) continue;
      uint32_t kh[4], kl[4], vh[4], vl[4];
      ldm3d::split_tf32_a(ka[kk * 8], ka[8 * LD + kk * 8], ka[kk * 8 + 4], ka[8 * LD + kk * 8 + 4],
                          kh, kl);
      ldm3d::split_tf32_a(va[kk * 8], va[8 * LD + kk * 8], va[kk * 8 + 4], va[8 * LD + kk * 8 + 4],
                          vh, vl);
#pragma unroll
      for (int c0 = 0; c0 < SN; c0 += GS) {
        uint32_t qh[GS][2], ql[GS][2], oh[GS][2], ol[GS][2];
#pragma unroll
        for (int j = 0; j < GS; ++j) {
          const int row = ((c0 + j) * 8 + g) * LD + kk * 8 + t;
          ldm3d::split_tf32(qt[row], qh[j][0], ql[j][0]);
          ldm3d::split_tf32(qt[row + 4], qh[j][1], ql[j][1]);
          ldm3d::split_tf32(ot[row], oh[j][0], ol[j][0]);
          ldm3d::split_tf32(ot[row + 4], oh[j][1], ol[j][1]);
        }
        ldm3d::mma_tf32x3_2<GS>(&s[c0], kh, kl, qh, ql, &dp[c0], vh, vl, oh, ol);
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
      const float nq[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
      const float dq2[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[c][e], scale_log2, nq[e & 1]));
        if (ragged && q0 + c * 8 + 2 * t + (e & 1) >= n) p = 0.f;
        s[c][e] = p;
        dp[c][e] = p * (dp[c][e] - dq2[e & 1]);
      }
    }

    // dV += P^T dO, then dK += dS^T Q, G n-tiles at a time; k-steps of 8
    // queries all past the edge (P = dS = 0) are skipped
    const int steps = min(SN, (n - q0 + 7) / 8);
#pragma unroll
    for (int c0 = 0; c0 < ON; c0 += G)
      if (col0 + c0 * 8 < d)
        acc_tile_tf32x3_2<G, SN, LD>(acc_v, s, ot + col0, acc_k, dp, qt + col0, c0, steps);
  }

  // dK = scale * acc_k and dV: each lane stores columns col0 + 8c + 2t, + 1
  // of its keys g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + warp * 16 + g + 8 * r;
    if (key >= kv_len) continue;
    const int64_t base = ((int64_t)(b * kv_len + key) * H + h) * d + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < ON; ++c)
      if (col0 + c * 8 < d) {
        *reinterpret_cast<float2*>(dk + base + c * 8) =
            make_float2(acc_k[c][2 * r] * scale, acc_k[c][2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dv + base + c * 8) =
            make_float2(acc_v[c][2 * r], acc_v[c][2 * r + 1]);
      }
  }
}

template <int DMAX>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dvec, void* dq, int B, int H, int n,
                           int kv_len, int d, const Strides& st, float scale, bool vec16,
                           cudaStream_t stream) {
  using T = DqTf32<DMAX>;
  static_assert(T::SMEM <= MAX_SMEM, "dQ tiles exceed a block's shared memory");
  auto kernel = flash_bwd_dq_tf32x3_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, T::SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + T::BM - 1) / T::BM * (int64_t)B * H));
  kernel<<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<float*>(dq), H, n, kv_len, d, st, scale,
      scale * LOG2E, (int)vec16);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* dk, void* dv, int B, int H,
                            int n, int kv_len, int d, const Strides& st, float scale, bool vec16,
                            cudaStream_t stream) {
  using T = DkvTf32<DMAX>;
  static_assert(T::SMEM <= MAX_SMEM, "dK/dV tiles exceed a block's shared memory");
  auto kernel = flash_bwd_dkv_tf32x3_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_once(kernel, T::SMEM, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((kv_len + T::BN - 1) / T::BN * (int64_t)B * H),
                  (d + T::DOUT - 1) / T::DOUT);
  kernel<<<grid, T::NT, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<float*>(dk), static_cast<float*>(dv), H, n,
      kv_len, d, st, scale, scale * LOG2E, (int)vec16);
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

// The fp32 route copies rows in 16-byte pieces when q, k, v and dO start on
// 16 bytes and all 12 strides are whole 16 bytes, else in 4-byte pieces.
bool rows_on_16_bytes(const void* q, const void* k, const void* v, const void* dout,
                      const int64_t* strides) {
  const auto a = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool ok = a(q) && a(k) && a(v) && a(dout);
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 4 == 0;
  return ok;
}

Strides to_strides(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// q, dO: (B, n, H, d); k, v: (B, kv_len, H, d); each with unit stride on d,
// and in bf16 with base pointers and strides on 16 bytes; d a multiple of 8,
// any B * H. Routes: d <= 256 by dtype, the bf16 or the 3xTF32 tensor-core
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
#define LDM3D_DQ(R, D, ...) \
  launch_dq_##R<D>(q, k, v, dout, lse, dvec, dq, B, H, n, kv_len, d, st, scale, __VA_ARGS__)
  if (d > 256) return (int)(is_bf16 ? LDM3D_DQ(wide, bf16, s) : LDM3D_DQ(wide, float, s));
  if (is_bf16) {
    if (d <= 64) return (int)LDM3D_DQ(bf16, 64, s);
    if (d <= 128) return (int)LDM3D_DQ(bf16, 128, s);
    return (int)LDM3D_DQ(bf16, 256, s);
  }
  const bool vec = rows_on_16_bytes(q, k, v, dout, strides);
  if (d <= 64) return (int)LDM3D_DQ(tf32, 64, vec, s);
  if (d <= 128) return (int)LDM3D_DQ(tf32, 128, vec, s);
  return (int)LDM3D_DQ(tf32, 256, vec, s);
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
#define LDM3D_DKV(R, D, ...) \
  launch_dkv_##R<D>(q, k, v, dout, lse, dvec, dk, dv, B, H, n, kv_len, d, st, scale, __VA_ARGS__)
  if (d > 256) return (int)(is_bf16 ? LDM3D_DKV(wide, bf16, s) : LDM3D_DKV(wide, float, s));
  if (is_bf16) {
    if (d <= 64) return (int)LDM3D_DKV(bf16, 64, s);
    if (d <= 128) return (int)LDM3D_DKV(bf16, 128, s);
    return (int)LDM3D_DKV(bf16, 256, s);
  }
  const bool vec = rows_on_16_bytes(q, k, v, dout, strides);
  if (d <= 64) return (int)LDM3D_DKV(tf32, 64, vec, s);
  if (d <= 128) return (int)LDM3D_DKV(tf32, 128, vec, s);
  return (int)LDM3D_DKV(tf32, 256, vec, s);
#undef LDM3D_DKV
}
