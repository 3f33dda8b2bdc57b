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
// in practice by the launch itself. In fp32 the bound is the tensor cores'
// 495 TFLOP/s of TF32 over the three products of the split below.
//
// Four routes, by dtype and head_dim; no switch and no fallback between
// them. Each grid puts batch * heads and the query tiles on grid.x (tiles
// of one (batch, head) side by side, bh = blockIdx.x / tiles), where the
// limit is 2^31 - 1 blocks:
//
// * bf16, d <= 128: flash_fwd_bf16_mma_kernel, FlashAttention-2 on the
//   warp-level tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators).
//   The building blocks are in mma_sm90.cuh.
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
//   - 128 rows a block halve the L2 traffic of 64-row blocks (every block
//     reads all of its head's K and V). Shared memory: 55,296 and 104,448
//     bytes for DMAX = 64 and 128.
//   - O is staged through the warp's own rows of the Q tile (no block
//     barrier) and written in 16-byte pieces.
//   The one rounding the fp32 plain version does not have is P to bf16
//   before P V, as in FlashAttention-2 (about 2^-9 of |O|); the row sums and
//   the LSE use the fp32 P.
//
// * bf16, 128 < d <= 256: flash_fwd_bf16_wgmma_kernel, the same algorithm
//   on Hopper's warpgroup products (wgmma) with operands that TMA loads.
//   mma.sync reached 181 TFLOP/s at (20, 8000, 1, 256) (7.25 ms, 5.5x its
//   bound; PERF.md): at d = 256 its O accumulator alone takes 128 registers
//   a thread of a 16-row warp tile, and only wgmma reaches the card's full
//   tensor-core rate. Design:
//   - a block of two warpgroups (64 query rows each, BM = 128); thread 0
//     also loads Q once and streams the K and V tiles of 64 keys with TMA
//     into a two-stage ring of mbarrier-guarded stages (Q 64 KB, four 32 KB
//     tiles: 197,760 bytes with the barriers and the alignment), so no other
//     thread spends a register or an instruction on a copy, and the next
//     stage lands while this one is multiplied. No producer warps: 256
//     threads may hold 255 registers each (O alone is 128 a thread). A
//     producer warp (288 threads, allocated as 12 warps: 168 registers) or
//     warpgroup with setmaxnreg (which this ptxas did not honour) spilled O
//     and serialized the wgmma (PERF.md).
//   - TMA boxes of 64 dims (128 bytes, the 128-byte swizzle's row; a 256-dim
//     row is four boxes) through tensor maps of the strided (B, n, H, d)
//     views, encoded on the host for each call; the zero fill covers query
//     rows past n, keys past kv_len and dims past d.
//   - S = Q K^T: wgmma m64n64k16, Q and K K-major from shared memory by
//     descriptor, the start address stepping 32 bytes a k-step inside the
//     swizzled row. O += P V: wgmma m64n256k16, P from S's accumulators as
//     the A registers (the accumulator layout of two n-tiles is a k-step's
//     A fragment, as with mma.sync), V MN-major by descriptor (the
//     transposed B). O is 128 fp32 registers a thread.
//   - online softmax and the LSE as the mma.sync kernel.
//   Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 2.93 ms at
//   (20, 8000, 1, 256), 447 TFLOP/s, 2.2x its bound (PERF.md).
//
// * fp32, d <= 256: flash_fwd_tf32x3_mma_kernel, the same FlashAttention-2
//   loop on mma.sync m16n8k8 with tf32 operands and fp32 accumulators. One
//   rounding of each operand to tf32 (10 mantissa bits) puts O and the LSE
//   past the fp32 limit of 1e-4 (emulated on the CPU in
//   tests/test_torch_attention.py: 1.0e-4 to 7.6e-4); so each operand is
//   split in registers into hi = tf32(x) and lo = tf32(x - hi) at its
//   fragment load, and each product is three mma (lo*hi + hi*lo + hi*hi),
//   which reads as full fp32 (at most 1.9e-6 in the emulation). This holds
//   for S = Q K^T and for O += P V.
//   - fragments: the tf32 C layout (columns 2t, 2t+1 of a quad) is not its A
//     layout (k columns t, t+4). P stays in S's accumulator registers, passed
//     as a0..a3 = c0, c2, c1, c3, so k index t stands for key 2t and t + 4
//     for 2t + 1, and V's B fragment is loaded in that key order. Q K^T uses
//     the same pairing over head dims, so a0/a2, a1/a3 and b0/b1 are each one
//     float2 load.
//   - shared memory: fp32 tiles, Q and K rows at a pitch of DMAX + 8 floats
//     and V rows at DMAX + 4, which keeps those 32- and 64-bit fragment loads
//     free of bank conflicts (ldmatrix is a b16 instruction). Q is resident;
//     K and V stream through a cp.async ring (4 slots of 64 keys up to
//     d = 128, 2 of 32 at 256) in 16-byte pieces, or 4-byte ones for views
//     off 16 bytes; src-size 0 zero-fills the ragged rows.
//   - 8 warps of 16 query rows; two blocks an SM at DMAX = 64 (128
//     registers), one above. Shared memory: 110,592, 208,896 and 202,752
//     bytes for DMAX = 64, 128 and 256.
//   It is the serving path (the JAX server serves fp32).
//
// * d > 256, either dtype: flash_fwd_wide_kernel, scalar FMA. grid.y splits
//   O's head dims into blocks of 128, so no block holds more than 128 output
//   dims; each block recomputes S over the whole d, streaming 32-dim chunks
//   of Q and K through shared memory, and takes P V for its own dims. A plain
//   route that is right; its times are in PERF.md.
//
// Every route masks the ragged edges: query rows past n load zeros and store
// nothing, keys past kv_len score -inf, and head dims past d (a multiple of
// 8: the wrapper zero-pads other widths) are not loaded and not stored. q, k
// and v are read through their (B, n, h, d) strides, so the views that split
// the attention block's fused qkv projection need no copy; the bf16 route
// needs their base pointers and strides on 16 bytes (the wrapper checks).

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "scalar_tiles.cuh"
#include "tensor_map.cuh"

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
// The launch plan of a shape: fwd_plan (below) makes it, the launchers and
// ldm3d_flash_fwd_plan read it

enum : int { ROUTE_BF16 = 0, ROUTE_WGMMA = 1, ROUTE_TF32 = 2, ROUTE_WIDE = 3 };

struct FwdPlan {
  int route;
  int dmax;  // the instantiation's head-dim bound (64, 128 or 256; 0 on the wide route)
  int64_t grid_x;
  int grid_y, threads;
  size_t smem;
};

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

// Grid (batch * heads * ceil(n / MMA_BM)), the query tiles of one (batch,
// head) side by side; MMA_WARPS warps of 16 query rows.
// The kv tiles stream through a ring of MMA_SLOTS slots as the sequence K_0,
// V_0, K_1, V_1, ...: while one slot is multiplied, the copies of the next
// MMA_SLOTS - 1 are in flight.
// At DMAX = 64 two blocks fit an SM (118 registers a thread); at 128 one
// block takes the register file, and without that bound ptxas would cap the
// registers at 128 and spill the accumulators.
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
  const int n_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * n_tiles) * BM;
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
cudaError_t launch_bf16(const FwdPlan& p, const void* q, const void* k, const void* v, void* o,
                        void* lse, int H, int n, int kv_len, int d, const int64_t* st,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DMAX>();
  static_assert(smem <= MAX_SMEM, "tiles exceed the shared memory of a block");
  auto kernel = flash_fwd_bf16_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, n, kv_len, d, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at 128 < d <= 256: warpgroup products (wgmma) on tiles that TMA loads

constexpr int WG_BM = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int WG_BN = 64;        // keys a K or V tile
constexpr int WG_STAGES = 2;     // K/V tile pairs in the ring
constexpr int WG_NT = 256;       // 2 warpgroups; thread 0 also issues the TMA loads
constexpr int WG_BOX = ldm3d::TMA_BOX_DIMS;  // head dims a TMA box (128 bytes: the swizzle's row)
constexpr int WG_NBOX = 4;       // boxes of a 256-dim row
constexpr uint32_t WG_Q_BOX_BYTES = WG_BOX * WG_BM * 2;   // 16 KB
constexpr uint32_t WG_KV_BOX_BYTES = WG_BOX * WG_BN * 2;  // 8 KB
constexpr uint32_t WG_Q_BYTES = WG_NBOX * WG_Q_BOX_BYTES;    // 64 KB
constexpr uint32_t WG_KV_BYTES = WG_NBOX * WG_KV_BOX_BYTES;  // 32 KB a K or V tile
constexpr uint32_t WG_TILES = WG_Q_BYTES + WG_STAGES * 2 * WG_KV_BYTES;  // 192 KB
// tiles, then 9 mbarriers (Q; full K, full V, empty K, empty V per stage),
// and up to 1 KB to align the tiles on the swizzle's 1024-byte atoms
constexpr size_t WG_SMEM = WG_TILES + 128 + 1024;

// Grid (batch * heads * ceil(n / WG_BM)), the query tiles of one (batch,
// head) side by side; two warpgroups of 64 query rows each. Thread 0 also
// issues the TMA loads of Q (once) and of the K and V tiles into a ring of
// WG_STAGES stages. Each K and each V tile has a "full" mbarrier (the TMA's
// bytes) and an "empty" one (one arrival from each warp once its products
// have read the tile); thread 0 refills a stage once it is empty. Each tile row of 256
// dims is four 64-dim boxes in the 128-byte swizzle. A consumer warpgroup,
// per kv tile: S = Q K^T as 4 * ceil(d / 64) wgmma m64n64k16 (Q and K by
// descriptor, both K-major), the online softmax on S's accumulators, then
// O += P V as 4 wgmma m64n256k16 with P in registers (the accumulators of
// two n-tiles are one k-step's A operand) and V by descriptor, MN-major.
// The two warpgroups' products and softmaxes interleave on the SM's tensor
// cores and ALUs; within a warpgroup they run in turn (issuing S of tile
// j + 1 beside P V of tile j was slower: writing P in place into S's
// accumulators while a product runs serializes the wgmma, PERF.md).
// d in (128, 256]: boxes past d are not loaded and their k-steps are
// skipped; the TMA zero-fills head dims past d inside a box, query rows past
// n and keys past kv_len (which are masked to -inf). O's columns past d are
// computed from unloaded V columns and never stored.
__global__ void __launch_bounds__(WG_NT, 1) flash_fwd_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int n, int kv_len, int d, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = ldm3d::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + WG_Q_BYTES;  // stage s: K at + 2s * WG_KV_BYTES, V after it
  const uint32_t bars = base + WG_TILES;
  const uint32_t bar_q = bars;
  // barrier i of kind 0 full K, 1 full V, 2 empty K, 3 empty V, for stage s
  auto bar = [&](int kind, int s) { return bars + 8u * (1 + kind * WG_STAGES + s); };

  const int n_tiles = (n + WG_BM - 1) / WG_BM;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * n_tiles) * WG_BM;
  const int nbox = (d + WG_BOX - 1) / WG_BOX;
  const int n_kv = (kv_len + WG_BN - 1) / WG_BN;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    ldm3d::mbar_init(bar_q, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      ldm3d::mbar_init(bar(0, s), 1);
      ldm3d::mbar_init(bar(1, s), 1);
      ldm3d::mbar_init(bar(2, s), 8);  // one arrival from each warp
      ldm3d::mbar_init(bar(3, s), 8);
    }
    ldm3d::mbar_fence_init();
  }
  __syncthreads();

  // thread 0: the TMA load of tile j's K (kind 0) or V (1) into its stage,
  // once both warpgroups have released the tile the stage held before
  auto load = [&](int kind, int j) {
    const int s = j % WG_STAGES;
    if (j >= WG_STAGES) ldm3d::mbar_wait(bar(2 + kind, s), (j / WG_STAGES - 1) & 1);
    ldm3d::mbar_arrive_expect_tx(bar(kind, s), nbox * WG_KV_BOX_BYTES);
    const uint32_t dst = kv_s + (2 * s + kind) * WG_KV_BYTES;
    for (int x = 0; x < nbox; ++x)
      ldm3d::tma_load_4d(dst + x * WG_KV_BOX_BYTES, kind ? &v_map : &k_map, bar(kind, s),
                         x * WG_BOX, j * WG_BN, h, b);
  };
  const bool producer = threadIdx.x == 0;
  if (producer) {
    ldm3d::tma_prefetch_desc(&q_map);
    ldm3d::tma_prefetch_desc(&k_map);
    ldm3d::tma_prefetch_desc(&v_map);
    ldm3d::mbar_arrive_expect_tx(bar_q, nbox * WG_Q_BOX_BYTES);
    for (int x = 0; x < nbox; ++x)
      ldm3d::tma_load_4d(q_s + x * WG_Q_BOX_BYTES, &q_map, bar_q, x * WG_BOX, row0, h, b);
    for (int j = 0; j < WG_STAGES && j < n_kv; ++j) {
      load(0, j);
      load(1, j);
    }
  }

  // warpgroup wg owns query rows 64 wg .. 64 wg + 63 of the block
  const int wg = threadIdx.x / 128;
  const int wq = (threadIdx.x / 32) % 4;  // the warp within the warpgroup
  const int g = lane / 4;
  const int t = lane % 4;
  const int ksteps = nbox * (WG_BOX / 16);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of S * scale * log2(e)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums of P
  const uint32_t q_wg = q_s + wg * (WG_BOX * 64 * 2);  // the warpgroup's 64 rows of each box
  auto k_tile = [&](int j) { return kv_s + 2 * (j % WG_STAGES) * WG_KV_BYTES; };
  auto parity = [&](int j) { return (uint32_t)((j / WG_STAGES) & 1); };
  auto release = [&](int kind, int j) {  // this warp is done with tile j's K (0) or V (1)
    __syncwarp();
    if (lane == 0) ldm3d::mbar_arrive(bar(2 + kind, j % WG_STAGES));
  };

  // S = Q K_j^T into sc, issued and committed (not waited for)
  auto issue_s = [&](float (&sc)[32], int j) {
    ldm3d::mbar_wait(bar(0, j % WG_STAGES), parity(j));
    const uint32_t k_s = k_tile(j);
    ldm3d::wgmma_fence_operands(sc);
    ldm3d::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      if (kk < ksteps) {
        const uint32_t off = (kk % 4) * 32u;  // the k-step's 32 bytes of the box's row
        ldm3d::wgmma_m64n64k16_ss(
            sc, ldm3d::wgmma_desc_sw128(q_wg + (kk / 4) * WG_Q_BOX_BYTES + off, 16, 1024),
            ldm3d::wgmma_desc_sw128(k_s + (kk / 4) * WG_KV_BOX_BYTES + off, 16, 1024), kk > 0);
      }
    }
    ldm3d::wgmma_commit();
  };
  // O += P V_j, issued and committed
  auto issue_pv = [&](uint32_t (&pa)[4][4], int j) {
    ldm3d::mbar_wait(bar(1, j % WG_STAGES), parity(j));
    const uint32_t v_s = k_tile(j) + WG_KV_BYTES;
    ldm3d::wgmma_fence_operands(acc);
    ldm3d::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // keys 16 kk .. 16 kk + 15: 2 groups of 8 rows
      ldm3d::wgmma_m64n256k16_rs_tnspb(
          acc, pa[kk], ldm3d::wgmma_desc_sw128(v_s + kk * 16 * 128, WG_KV_BOX_BYTES, 1024), 1);
    ldm3d::wgmma_commit();
  };
  // the online softmax of tile j on sc (rows g and g + 8 of the warp's 16,
  // their 64 keys over the four lanes of a quad): keys past kv_len to -inf,
  // the new row max, P = exp2(S * scale * log2(e) - max) in place in fp32,
  // the row sums; alpha is the factor O must be scaled by
  auto softmax = [&](float (&sc)[32], int j, float (&alpha)[2]) {
    const int kv0 = j * WG_BN;
    if (kv0 + WG_BN > kv_len) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + c * 8 + 2 * t + (e & 1) >= kv_len) sc[4 * c + e] = -INFINITY;
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      mt[0] = fmaxf(mt[0], fmaxf(sc[4 * c], sc[4 * c + 1]));
      mt[1] = fmaxf(mt[1], fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
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
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[r]));
      l[r] += sc[i];
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      acc[4 * c] *= alpha[0];
      acc[4 * c + 1] *= alpha[0];
      acc[4 * c + 2] *= alpha[1];
      acc[4 * c + 3] *= alpha[1];
    }
  };
  // P rounded to bf16 into the A registers of the 4 k-steps of 16 keys:
  // k-step kk takes n-tiles 2kk and 2kk + 1 (a0, a1 of the first, a2, a3 of
  // the second; rows g and g + 8)
  auto pack = [&](const float (&sc)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 2 * kk + half;
        pa[kk][2 * half] = ldm3d::pack_bf16(sc[4 * c], sc[4 * c + 1]);
        pa[kk][2 * half + 1] = ldm3d::pack_bf16(sc[4 * c + 2], sc[4 * c + 3]);
      }
  };

  ldm3d::mbar_wait(bar_q, 0);
  float sc[32], alpha[2];
  uint32_t pa[4][4];
  // after this warp's release of tile j's K or V, thread 0 refills the
  // stage with tile j + WG_STAGES
  auto refill = [&](int kind, int j) {
    if (producer && j + WG_STAGES < n_kv) load(kind, j + WG_STAGES);
  };
  for (int j = 0; j < n_kv; ++j) {
    issue_s(sc, j);
    ldm3d::wgmma_wait<0>();
    ldm3d::wgmma_fence_operands(sc);
    release(0, j);
    refill(0, j);
    softmax(sc, j, alpha);
    rescale(alpha);
    pack(sc, pa);
    issue_pv(pa, j);
    ldm3d::wgmma_wait<0>();
    ldm3d::wgmma_fence_operands(acc);
    release(1, j);
    refill(1, j);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  // each lane stores columns 8c + 2t, 8c + 2t + 1 of its rows g and g + 8
  const int row_w = row0 + wg * 64 + wq * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + 8 * r;
    if (row >= n) continue;
    bf16* orow = o + ((int64_t)(b * n + row) * H + h) * d + 2 * t;
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (c * 8 < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 8) =
            __floats2bfloat162_rn(acc[4 * c + 2 * r] * inv[r], acc[4 * c + 2 * r + 1] * inv[r]);
    if (t == 0) lse[(int64_t)bh * n + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
}

// The maps of q, k and v for the wgmma kernel (strides as ldm3d_flash_fwd's)
void wgmma_map_fields(ldm3d::MapFields (&f)[3], int B, int H, int n, int kv_len, int d,
                      const int64_t* st) {
  using ldm3d::bf16_map_fields;
  f[0] = bf16_map_fields(B, n, H, d, st[0], st[1], st[2], WG_BM);
  f[1] = bf16_map_fields(B, kv_len, H, d, st[3], st[4], st[5], WG_BN);
  f[2] = bf16_map_fields(B, kv_len, H, d, st[6], st[7], st[8], WG_BN);
}

cudaError_t launch_bf16_wgmma(const FwdPlan& p, const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int H, int n, int kv_len, int d,
                              const int64_t* st, float scale, cudaStream_t stream) {
  static_assert(WG_SMEM <= MAX_SMEM, "tiles exceed the shared memory of a block");
  ldm3d::MapFields f[3];
  wgmma_map_fields(f, B, H, n, kv_len, d, st);
  CUtensorMap qm, km, vm;
  if (!ldm3d::encode_bf16_map(&qm, q, f[0]) || !ldm3d::encode_bf16_map(&km, k, f[1]) ||
      !ldm3d::encode_bf16_map(&vm, v, f[2]))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16_wgmma_kernel;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, WG_SMEM, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), static_cast<float*>(lse), H, n, kv_len, d,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: tensor cores in TF32, each operand split in two (3xTF32)

constexpr int TF_WARPS = 8;
constexpr int TF_BM = 16 * TF_WARPS;  // query rows per block
constexpr int TF_NT = 32 * TF_WARPS;  // threads per block

// BN keys a K or V tile, SLOTS tiles in the ring. Rows of Q and K have a
// pitch of DMAX + 8 floats (8 mod 32: the float2 fragment loads of a
// half-warp, rows g and columns 2t, hit 32 different banks); rows of V
// DMAX + 4 (4 mod 32: the B loads, rows 2t and 2t + 1 and column g, do).
template <int DMAX>
struct Tf32Tiles {
  static constexpr int BN = DMAX > 128 ? 32 : 64;
  static constexpr int SLOTS = DMAX > 128 ? 2 : 4;
  static constexpr int LDQ = DMAX + 8;
  static constexpr int LDV = DMAX + 4;
  static constexpr size_t SMEM = (size_t)(TF_BM + SLOTS * BN) * LDQ * sizeof(float);
};

// Grid (batch * heads * ceil(n / TF_BM)); TF_WARPS warps of 16 query rows.
// As the bf16 kernel: Q resident, K_0, V_0, K_1, ... through a cp.async
// ring, the online softmax in registers. Every product is three mma.sync
// m16n8k8 on tf32 parts split in registers at each fragment load (split_tf32:
// lo*hi, hi*lo, hi*hi into one fp32 accumulator).
// The three mma of a product go to one accumulator, and each waits for the
// one before; so G = 4 n-tiles are taken together, their lo*hi products
// first, then hi*lo, then hi*hi.
// - S = Q K^T: k-step kk covers head dims 8kk .. 8kk + 7, k index t standing
//   for dim 8kk + 2t and t + 4 for 8kk + 2t + 1, so that a0/a2 (and a1/a3,
//   and b0/b1) are one float2 load.
// - O += P V: P stays in the registers of S's accumulators. For the 8 keys
//   of n-tile kk, a0, a1, a2, a3 = c0, c2, c1, c3: k index t stands for key
//   2t and t + 4 for key 2t + 1, and V's B fragment is loaded in that order,
//   b0 = V[2t][g], b1 = V[2t + 1][g] (tests/test_torch_attention.py emulates
//   the mapping on the CPU).
// At DMAX = 64 two blocks share an SM (their registers capped at 128); above,
// one block takes the register file.
template <int DMAX>
__global__ void __launch_bounds__(TF_NT, DMAX <= 64 ? 2 : 1) flash_fwd_tf32x3_mma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int H, int n, int kv_len, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh,
    int64_t v_sb, int64_t v_sn, int64_t v_sh, float scale_log2, int vec16) {
  using T = Tf32Tiles<DMAX>;
  constexpr int BM = TF_BM;
  constexpr int BN = T::BN;
  constexpr int NSLOT = T::SLOTS;
  constexpr int LDQ = T::LDQ;
  constexpr int LDV = T::LDV;
  constexpr int KS = DMAX / 8;  // k-steps of Q K^T over the head dim
  constexpr int SN = BN / 8;    // 8-key n-tiles of S, and k-steps of P V
  constexpr int ON = DMAX / 8;  // 8-column n-tiles of O
  constexpr int G = 4;          // n-tiles whose products interleave
  static_assert(NSLOT >= 2 && SN % G == 0 && ON % G == 0, "tiles are whole mma groups");
  extern __shared__ __align__(128) float smem_f[];
  float* qs = smem_f;            // BM x LDQ
  float* slots = qs + BM * LDQ;  // NSLOT x BN x LDQ (a V tile at pitch LDV)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n_tiles = (n + BM - 1) / BM;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * n_tiles) * BM;
  const int n_items = 2 * ((kv_len + BN - 1) / BN);

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  auto issue = [&](int item) {
    if (item < n_items) {
      float* slot = slots + item % NSLOT * BN * LDQ;
      if (item & 1)
        ldm3d::load_rows_f32<BN, LDV, DMAX, TF_NT>(slot, vb, v_sn, item / 2 * BN, kv_len, d,
                                                   vec16);
      else
        ldm3d::load_rows_f32<BN, LDQ, DMAX, TF_NT>(slot, kb, k_sn, item / 2 * BN, kv_len, d,
                                                   vec16);
    }
    ldm3d::cp_async_commit();
  };
  ldm3d::load_rows_f32<BM, LDQ, DMAX, TF_NT>(qs, qb, q_sn, row0, n, d, vec16);  // with item 0
#pragma unroll
  for (int i = 0; i < NSLOT - 1; ++i) issue(i);

  const float* qa = qs + (warp * 16 + g) * LDQ + 2 * t;  // A rows g and g + 8
  const int kb_off = g * LDQ + 2 * t;                    // K row (key) g of an n-tile
  const int vb_off = 2 * t * LDV + g;                    // V rows 2t, 2t + 1, column g

  float acc[ON][4];
#pragma unroll
  for (int c = 0; c < ON; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of S * scale * log2(e)
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums of P

  for (int item = 0; item < n_items; item += 2) {
    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(item + NSLOT - 1);
    const float* ks = slots + item % NSLOT * BN * LDQ + kb_off;

    float s[SN][4];
#pragma unroll
    for (int c = 0; c < SN; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk * 8 >= d) continue;
      const float2 q0 = *reinterpret_cast<const float2*>(qa + kk * 8);
      const float2 q1 = *reinterpret_cast<const float2*>(qa + 8 * LDQ + kk * 8);
      uint32_t ah[4], al[4];
      ldm3d::split_tf32(q0.x, ah[0], al[0]);
      ldm3d::split_tf32(q1.x, ah[1], al[1]);
      ldm3d::split_tf32(q0.y, ah[2], al[2]);
      ldm3d::split_tf32(q1.y, ah[3], al[3]);
      // G n-tiles at a time, each product's three mma G apart
#pragma unroll
      for (int c0 = 0; c0 < SN; c0 += G) {
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(ks + (c0 + j) * 8 * LDQ + kk * 8);
          ldm3d::split_tf32(kv.x, bh[j][0], bl[j][0]);
          ldm3d::split_tf32(kv.y, bh[j][1], bl[j][1]);
        }
        ldm3d::mma_tf32x3<G>(&s[c0], ah, al, bh, bl);
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

    // online softmax, as the bf16 kernel
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

    ldm3d::cp_async_wait<NSLOT - 2>();
    __syncthreads();
    issue(item + NSLOT);
    const float* vs = slots + (item + 1) % NSLOT * BN * LDQ + vb_off;

#pragma unroll
    for (int kk = 0; kk < SN; ++kk) {
      // P of n-tile kk in fp32 for the row sums, as the A fragment of keys
      // kv0 + 8kk .. + 7: a0 = c0, a1 = c2, a2 = c1, a3 = c3
      const float p0 = exp2f(fmaf(s[kk][0], scale_log2, -m[0]));
      const float p1 = exp2f(fmaf(s[kk][1], scale_log2, -m[0]));
      const float p2 = exp2f(fmaf(s[kk][2], scale_log2, -m[1]));
      const float p3 = exp2f(fmaf(s[kk][3], scale_log2, -m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      if (kv0 + kk * 8 >= kv_len) continue;  // all 8 keys past the edge: P = 0
      uint32_t ph[4], pl[4];
      ldm3d::split_tf32(p0, ph[0], pl[0]);
      ldm3d::split_tf32(p2, ph[1], pl[1]);
      ldm3d::split_tf32(p1, ph[2], pl[2]);
      ldm3d::split_tf32(p3, ph[3], pl[3]);
#pragma unroll
      for (int c0 = 0; c0 < ON; c0 += G) {
        if (c0 * 8 >= d) continue;  // n-tiles of a group past d are computed, not stored
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float* vr = vs + kk * 8 * LDV + (c0 + j) * 8;
          ldm3d::split_tf32(vr[0], bh[j][0], bl[j][0]);
          ldm3d::split_tf32(vr[LDV], bh[j][1], bl[j][1]);
        }
        ldm3d::mma_tf32x3<G>(&acc[c0], ph, pl, bh, bl);
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
  // each lane stores columns 8c + 2t, 8c + 2t + 1 of its rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    float* orow = o + ((int64_t)(b * n + row) * H + h) * d + 2 * t;
#pragma unroll
    for (int c = 0; c < ON; ++c)
      if (c * 8 < d)
        *reinterpret_cast<float2*>(orow + c * 8) =
            make_float2(acc[c][2 * r] * inv[r], acc[c][2 * r + 1] * inv[r]);
    if (t == 0) lse[(int64_t)bh * n + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
}

template <int DMAX>
cudaError_t launch_tf32(const FwdPlan& p, const void* q, const void* k, const void* v, void* o,
                        void* lse, int H, int n, int kv_len, int d, const int64_t* st,
                        float scale, bool vec16, cudaStream_t stream) {
  constexpr size_t smem = Tf32Tiles<DMAX>::SMEM;
  static_assert(smem <= MAX_SMEM, "tiles exceed the shared memory of a block");
  auto kernel = flash_fwd_tf32x3_mma_kernel<DMAX>;
  static std::atomic<unsigned long long> opted_in{0};
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), H, n, kv_len, d, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale * 1.4426950408889634f, (int)vec16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// head_dim > 256, either dtype: scalar FMA, the output's head dims over grid.y

constexpr int W_T = 16;           // the block is W_T x W_T threads
constexpr int W_NT = W_T * W_T;
constexpr int W_BM = 64;          // query rows per block
constexpr int W_BN = 32;          // keys per kv tile
constexpr int W_DC = 32;          // head dims per chunk of Q K^T
constexpr int W_DOUT = 128;       // head dims of O per block

// Grid (batch * heads * ceil(n / W_BM), ceil(d / W_DOUT)). Each block owns
// W_BM query rows and W_DOUT head dims of O, and recomputes S over the whole
// d, streaming W_DC-dim chunks of Q and K through shared memory; P goes
// through shared memory to the P V product. Thread (ty, tx) owns rows
// ty + 16i, keys tx + 16j and head dims tx + 16c. The blocks of grid.y = 0
// write the LSE.
template <typename T>
__global__ void __launch_bounds__(W_NT) flash_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int H, int n, int kv_len, int d, int64_t q_sb, int64_t q_sn,
    int64_t q_sh, int64_t k_sb, int64_t k_sn, int64_t k_sh, int64_t v_sb, int64_t v_sn,
    int64_t v_sh, float scale) {
  constexpr int RM = W_BM / W_T;
  constexpr int RN = W_BN / W_T;
  constexpr int RD = W_DOUT / W_T;
  __shared__ float qc[W_BM][W_DC + 1];
  __shared__ float kc[W_BN][W_DC + 1];
  __shared__ float vt[W_BN][W_DOUT + 1];
  __shared__ float ps[W_BM][W_BN + 1];

  const int tx = threadIdx.x % W_T;
  const int ty = threadIdx.x / W_T;
  const int n_tiles = (n + W_BM - 1) / W_BM;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = (blockIdx.x - bh * n_tiles) * W_BM;
  const int col0 = blockIdx.y * W_DOUT;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  float acc[RM][RD];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += W_BN) {
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += W_DC) {
      __syncthreads();  // the previous chunk, P and the V tile are no longer read
      ldm3d::load_chunk<W_BM, W_DC, W_NT>(qc, qb, q_sn, row0, n, c0, d);
      ldm3d::load_chunk<W_BN, W_DC, W_NT>(kc, kb, k_sn, kv0, kv_len, c0, d);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < W_DC; ++c) {
        float qv[RM], kv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = qc[ty + W_T * i][c];
#pragma unroll
        for (int j = 0; j < RN; ++j) kv[j] = kc[tx + W_T * j][c];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    // online softmax over the tile (a 16-lane half-warp holds one row's
    // 16 tx); every tile holds a valid key
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = kv0 + tx + W_T * j < kv_len ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = W_T / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[ty + W_T * i][tx + W_T * j] = p;
      }
#pragma unroll
      for (int off = W_T / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
    }
    ldm3d::load_chunk<W_BN, W_DOUT, W_NT>(vt, vb, v_sn, kv0, kv_len, col0, d);
    __syncthreads();  // P and the V tile are visible

    const int nk = min(W_BN, kv_len - kv0);
    for (int kk = 0; kk < nk; ++kk) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[ty + W_T * i][kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        const float vv = vt[kk][tx + W_T * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + W_T * i;
    if (row >= n) continue;
    T* orow = o + ((int64_t)(b * n + row) * H + h) * d;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = col0 + tx + W_T * c;
      if (col < d) ldm3d::store(orow + col, acc[i][c] / l[i]);
    }
    if (tx == 0 && blockIdx.y == 0) lse[(int64_t)bh * n + row] = m[i] + logf(l[i]);
  }
}

template <typename T>
cudaError_t launch_wide(const FwdPlan& p, const void* q, const void* k, const void* v, void* o,
                        void* lse, int H, int n, int kv_len, int d, const int64_t* st,
                        float scale, cudaStream_t stream) {
  flash_fwd_wide_kernel<T><<<dim3((unsigned)p.grid_x, p.grid_y), p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, n, kv_len, d, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

// 16-byte pieces need base pointers and row strides on 16 bytes
bool rows_on_16_bytes(const void* q, const void* k, const void* v, const int64_t* st) {
  const auto a = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool ok = a(q) && a(k) && a(v);
  for (int i = 0; i < 9; ++i) ok = ok && st[i] % 4 == 0;
  return ok;
}

bool bad_shape(int B, int H, int n, int kv_len, int d) {
  const int64_t blocks = (int64_t)B * H * ((n + W_BM - 1) / W_BM);
  return B <= 0 || H <= 0 || n <= 0 || kv_len <= 0 || d <= 0 || d % 8 != 0 ||
         blocks > INT32_MAX;
}

// The route and launch of a shape: bf16 up to d = 128 on mma.sync, bf16 at
// 128 < d <= 256 on wgmma, fp32 up to 256 on 3xTF32 mma.sync, and either
// dtype above 256 on the wide kernel. Query tiles of one (batch, head) side
// by side on grid.x; the wide route's blocks of 128 head dims on grid.y.
FwdPlan fwd_plan(int is_bf16, int B, int H, int n, int d) {
  const int64_t bh = (int64_t)B * H;
  const int dmax = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  if (d > 256)
    return {ROUTE_WIDE, 0, (n + W_BM - 1) / W_BM * bh, (d + W_DOUT - 1) / W_DOUT, W_NT, 0};
  if (is_bf16 && d > 128)
    return {ROUTE_WGMMA, 256, (n + WG_BM - 1) / WG_BM * bh, 1, WG_NT, WG_SMEM};
  if (is_bf16)
    return {ROUTE_BF16, dmax, (n + MMA_BM - 1) / MMA_BM * bh, 1, MMA_NT,
            dmax == 64 ? mma_smem_bytes<64>() : mma_smem_bytes<128>()};
  return {ROUTE_TF32, dmax, (n + TF_BM - 1) / TF_BM * bh, 1, TF_NT,
          dmax == 64    ? Tf32Tiles<64>::SMEM
          : dmax == 128 ? Tf32Tiles<128>::SMEM
                        : Tf32Tiles<256>::SMEM};
}

}  // namespace

// The launch plan of ldm3d_flash_fwd for a shape, as the launch reads it:
// out[0..4] = {route, grid_x, grid_y, threads, dynamic shared-memory bytes},
// route 0 for the bf16 mma.sync kernel, 1 the bf16 wgmma kernel, 2 the fp32
// 3xTF32 kernel, 3 the wide kernel. On route 1, out[5..37] are the tensor
// maps of q, k and v for the strides `st` (ordered as ldm3d_flash_fwd's),
// 11 each: dims (4), byte strides of dims 1-3 (3), box (4). Returns 0, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int ldm3d_flash_fwd_plan(int is_bf16, int B, int H, int n, int kv_len, int d,
                                    const int64_t* st, int64_t* out) {
  if (bad_shape(B, H, n, kv_len, d)) return (int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(is_bf16, B, H, n, d);
  out[0] = p.route, out[1] = p.grid_x, out[2] = p.grid_y, out[3] = p.threads, out[4] = p.smem;
  if (p.route == ROUTE_WGMMA) {
    ldm3d::MapFields f[3];
    wgmma_map_fields(f, B, H, n, kv_len, d, st);
    int64_t* o = out + 5;
    for (const ldm3d::MapFields& m : f) o = ldm3d::put_map_fields(o, m);
  }
  return 0;
}

// q, k, v: (B, n|kv_len, H, d) with unit stride on d; strides in elements,
// ordered (q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh); in bf16
// the base pointers and strides are multiples of 16 bytes. d is a multiple
// of 8 (the wrapper pads other widths); any d, n, kv_len and B * H the grid
// holds (blocks up to 2^31 - 1). scale multiplies the logits.
// o: contiguous (B, n, H, d) in the input dtype. lse: contiguous (B*H, n) fp32.
// Routes (fwd_plan): d <= 128 bf16 flash_fwd_bf16_mma_kernel, 128 < d <= 256
// bf16 flash_fwd_bf16_wgmma_kernel, d <= 256 fp32 flash_fwd_tf32x3_mma_kernel;
// d > 256 flash_fwd_wide_kernel.
// Returns the launch's cudaError_t (0 on success); allocates nothing.
extern "C" int ldm3d_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int is_bf16, int B, int H, int n, int kv_len, int d,
                               const int64_t* st, float scale, void* stream) {
  if (bad_shape(B, H, n, kv_len, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdPlan p = fwd_plan(is_bf16, B, H, n, d);
  switch (p.route) {
    case ROUTE_WIDE:
      if (is_bf16)
        return (int)launch_wide<bf16>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, s);
      return (int)launch_wide<float>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, s);
    case ROUTE_WGMMA:
      return (int)launch_bf16_wgmma(p, q, k, v, o, lse, B, H, n, kv_len, d, st, scale, s);
    case ROUTE_BF16:
      if (p.dmax == 64)
        return (int)launch_bf16<64>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, s);
      return (int)launch_bf16<128>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, s);
    default: {
      const bool vec = rows_on_16_bytes(q, k, v, st);
      if (p.dmax == 64)
        return (int)launch_tf32<64>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, vec, s);
      if (p.dmax == 128)
        return (int)launch_tf32<128>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, vec, s);
      return (int)launch_tf32<256>(p, q, k, v, o, lse, H, n, kv_len, d, st, scale, vec, s);
    }
  }
}
