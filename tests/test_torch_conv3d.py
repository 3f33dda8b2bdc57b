"""The implicit-GEMM conv (B6): the port's ``conv3d_igemm`` against the JAX one.

On the CPU the port's wrapper runs its plain version, held here against
JAX's Pallas kernel in interpret mode and against ``conv3d_xla`` at
``tests/test_conv3d.py``'s five shapes. Tolerances as JAX's own test: fp32
1e-5 and bf16 2e-2 of the largest |reference|. The ``cuda``-marked test
holds the CUDA kernel against the plain version on the card (fp32 1e-5,
bf16 2^-7 of the largest |plain|: one bf16 ulp, both round the same fp32
sum); run it there with ``python -m pytest --noconftest -m cuda
tests/test_torch_conv3d.py``, which needs no JAX.

The kernels (``csrc/conv3d_igemm.cu``) run on the tensor cores: bf16 on
``wgmma``, and in fp32 TF32 ``mma.sync`` with each operand split into a tf32
hi and lo part (3xTF32). Its launch plan (:func:`conv3d_plan`) is held
here to cover every output voxel once within the card's shared memory, and
its fp32 arithmetic is emulated: the split, the fragments' k order, and the
tensor cores' truncated mma sums, which the kernel sums per tap in a zeroed
partial.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ldm3d_torch.ops import conv3d as tconv
from ldm3d_torch.tools.conv_ab import SHAPES as AB_SHAPES

torch.set_num_threads(1)

SHAPES = [
    (1, 3, 8, 8, 8, 8),      # generic tiny
    (2, 4, 8, 16, 16, 8),    # multi-batch, rectangular plane, cout != cin
    (1, 2, 4, 8, 64, 64),    # the lane-starved L0 channel width
    (1, 2, 6, 8, 3, 5),      # odd channel counts
    (1, 1, 4, 8, 8, 8),      # single depth plane (both halo planes zero)
]


def _inputs(shape, seed):
    B, D, H, W, C, CO = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, CO)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_xla(shape, dtype):
    import jax.numpy as jnp

    from ldm3d_tpu.ops.conv3d import conv3d_igemm, conv3d_xla

    x, w = _inputs(shape, seed=sum(shape))
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    H, W = shape[2], shape[3]
    refs = [np.asarray(conv3d_xla(jx, jw).astype(jnp.float32)),
            np.asarray(conv3d_igemm(jx, jw, tile_m=max(H * W // 2, 8),
                                    interpret=True).astype(jnp.float32))]
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    before = tconv.conv3d_igemm.launches
    out = tconv.conv3d_igemm(tx, tw)
    assert tconv.conv3d_igemm.launches == before  # the CPU runs the plain version
    assert out.dtype == tx.dtype and out.shape == (*shape[:4], shape[5])
    out = out.float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for ref in refs:
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(ref - out).max()) / scale < tol


def test_rejects_untargeted_shapes():
    x = torch.zeros((1, 2, 4, 8, 8))
    with pytest.raises(ValueError, match="3x3x3"):
        tconv.conv3d_igemm(x, torch.zeros((5, 5, 5, 8, 8)))
    with pytest.raises(ValueError, match="C <= 64"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 8, 128)), torch.zeros((3, 3, 3, 128, 128)))
    with pytest.raises(ValueError, match="W % 8"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 12, 8)), torch.zeros((3, 3, 3, 8, 8)))
    with pytest.raises(ValueError, match="no gradient"):
        tconv.conv3d_igemm(x.requires_grad_(), torch.zeros((3, 3, 3, 8, 8)))
    with pytest.raises(ValueError, match="dtype"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 8, 8)),
                           torch.zeros((3, 3, 3, 8, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 8, 8), device="meta"),
                           torch.zeros((3, 3, 3, 8, 8), device="meta"))


def test_plain_is_the_padded_tap_sum():
    """conv3d_ref is F.conv3d's SAME cross-correlation, computed in fp32."""
    x, w = _inputs((2, 3, 4, 8, 5, 6), seed=9)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref = torch.nn.functional.conv3d(tx.permute(0, 4, 1, 2, 3), tw.permute(4, 3, 0, 1, 2),
                                     padding=1).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(tconv.conv3d_ref(tx, tw), ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 3, 80, 80, 64, 64), (2, 2, 96, 96, 64, 64)])
def test_cuda_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, w = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
            for a in _inputs(shape, seed=sum(shape)))
    before = tconv.conv3d_igemm.launches
    out = tconv.conv3d_igemm(x, w)
    torch.cuda.synchronize()
    assert tconv.conv3d_igemm.launches == before + 1
    ref = tconv.conv3d_ref(x, w).float()
    rel = 2.0**-7 if dtype == "bfloat16" else 1e-5
    assert (out.float() - ref).abs().max().item() <= rel * ref.abs().max().item()


# --- the CUDA kernel's launch plan

# (B, D, H, W, C, Cout): the cuda tests' edge shapes (W = 8 with C = 3 and
# Cout = 5, one plane, B * D at its cap, Cout > 64)
EDGE_SHAPES = [(1, 1, 4, 8, 3, 5), (3, 21845, 1, 8, 3, 5), (1, 2, 8, 16, 16, 130),
               (1, 2, 5, 24, 64, 80)]
PLAN_SHAPES = ([(*s, s[4]) for s in AB_SHAPES] + SHAPES
               + [(1, 3, 80, 80, 64, 64), (2, 2, 96, 96, 64, 64)] + EDGE_SHAPES)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_plan_covers_each_output_once_within_shared_memory(shape, dtype):
    """The grid, decoded as the kernel decodes blockIdx (column tiles
    fastest, then row tiles, then (b, d) planes; 64 output channels on
    grid.y), writes every output voxel and channel exactly once, and a
    block's shared memory fits the card."""
    B, D, H, W, C, cout = shape
    plan = tconv.conv3d_plan((B, D, H, W, C), cout, dtype)
    tw, th = plan["tile_w"], plan["tile_h"]
    assert W % tw == 0 and tw * th == (256 if dtype == torch.bfloat16 else 128)
    assert plan["smem_bytes"] <= SMEM_LIMIT and plan["threads"] == 256
    wtiles, htiles = W // tw, math.ceil(H / th)
    gx, gy = plan["grid"]
    assert gx == B * D * htiles * wtiles and gx < 2**31 and gy * 64 >= cout > (gy - 1) * 64
    cover = np.zeros((H, W), dtype=np.int64)
    for bx in range(htiles * wtiles):  # one plane's blocks; every (b, d) has the same
        wt, ht = bx % wtiles, bx // wtiles
        cover[ht * th:ht * th + th, wt * tw:wt * tw + tw] += 1
    assert (cover == 1).all()
    assert sorted({bx // (htiles * wtiles) for bx in (0, gx - 1)}) == sorted({0, B * D - 1})


# --- the fp32 kernel's arithmetic: 3xTF32, the fragments' k order, the
# tensor cores' truncated sums

FP32_REL = 1e-5          # the card's fp32 limit: 1e-5 of the largest |plain|
FP32_MARGIN = 0.25       # the emulation stays this far inside it


def _tf32_rna(x):
    """x rounded to tf32, to nearest with ties away from zero (split_tf32's hi)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _rz_fp32(x):
    """float64 to fp32, rounded toward zero: how an mma's sum is stored."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _im2col(x):
    """(B*D*H*W, 27*C): each output voxel's 27 taps of C channels, tap-major
    (kd, kh, kw), zeros past the borders; the kernel's K order."""
    B, D, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    return torch.cat([xp[:, kd:kd + D, kh:kh + H, kw:kw + W]
                      for kd in range(3) for kh in range(3) for kw in range(3)],
                     -1).reshape(-1, 27 * C)


def _frag_order(a_regs, b_rows):
    """The source column of A and source row of B that each k index of an
    m16n8k8 tf32 mma stands for. ``a_regs(g, t)``: the (row, column) of the
    source tile that lane 4g + t puts in a0..a3, read by the tensor core as
    A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; ``b_rows(g, t)``: the source
    rows of b0, b1, read as B[t][g], B[t+4][g]."""
    a_col, b_row = {}, {}
    for lane in range(32):
        g, t = divmod(lane, 4)
        for (row, col), (r, k) in zip(a_regs(g, t), ((g, t), (g + 8, t), (g, t + 4),
                                                      (g + 8, t + 4))):
            assert row == r
            assert a_col.setdefault(k, col) == col
        for src, k in zip(b_rows(g, t), (t, t + 4)):
            assert b_row.setdefault(k, src) == src
    return [a_col[k] for k in range(8)], [b_row[k] for k in range(8)]


def _ldmatrix_a(g, t):
    """The kernel's A fragment: ldmatrix.x4 of four 8 x 4 fp32 matrices, lane
    L giving the address of row L % 16 at 4-float column L / 16; register j
    is matrix j's element (row g, column t) for each lane."""
    rows = [lane % 16 for lane in range(32)]
    cols = [4 * (lane // 16) for lane in range(32)]
    out = []
    for j in range(4):
        lane_of_row = 8 * j + g  # matrix j's rows come from lanes 8j .. 8j + 7
        out.append((rows[lane_of_row], cols[lane_of_row] + t))
    return out


# the kernel: A by ldmatrix, B by scalar loads of weight rows t and t + 4
KERNEL_ORDER = _frag_order(_ldmatrix_a, lambda g, t: [t, t + 4])
# B rows loaded as pairs 2t, 2t + 1 (the attention kernels' accumulator-fed order)
PAIRED_B_ORDER = (KERNEL_ORDER[0], [0, 2, 4, 6, 1, 3, 5, 7])


def _tf32x3_conv(x, w, order=KERNEL_ORDER, split=True, tap_partials=True):
    """The fp32 kernel's arithmetic in plain torch: the implicit GEMM of
    :func:`_im2col` by w in mma steps of 8 along K in the fragments' k
    ``order``; each operand split into tf32 hi (to nearest) and lo (the
    truncated remainder), the three products lo*hi, hi*lo, hi*hi each added
    exactly and the sum truncated toward zero to fp32, as the tensor cores
    store it (``split=False``: each operand rounded once, one product). With
    ``tap_partials`` each tap's C channels go to a zeroed partial added to
    the fp32 result to nearest (the kernel), else one chain runs over all of
    K. Returns (voxels, Cout) fp32."""
    a, b = _im2col(x), w.reshape(-1, w.shape[-1])
    k, C = a.shape[1], x.shape[-1]
    a_cols, b_rows = order
    steps = torch.arange(0, k, 8)[:, None]
    a = a[:, (steps + torch.tensor(a_cols)).reshape(-1)]
    b = b[(steps + torch.tensor(b_rows)).reshape(-1)]
    if split:
        ah, bh = _tf32_rna(a), _tf32_rna(b)
        al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
        parts = [(al.double(), bh.double()), (ah.double(), bl.double()),
                 (ah.double(), bh.double())]
    else:
        parts = [(_tf32_rna(a).double(), _tf32_rna(b).double())]
    out = part = torch.zeros((a.shape[0], b.shape[1]))
    for s in range(0, k, 8):
        for u, v in parts:
            part = _rz_fp32(part.double() + u[:, s:s + 8] @ v[s:s + 8])
        if tap_partials and (s + 8) % C == 0:
            out, part = out + part, torch.zeros_like(part)
    return out if tap_partials else part


def _conv_case(seed, C=64):
    """conv_ab's draws at C = 64 (K = 27 * 64 = 1728): x ~ N(0, 1), w ~
    N(0, 1/C); 256 output voxels, 64 channels."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, 2, 8, 16, C), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, C, 64)) * C**-0.5).astype(np.float32))
    return x, w, tconv.conv3d_ref(x, w).reshape(-1, 64)


def _share(got, ref):
    return ((got - ref).abs().max() / (FP32_REL * ref.abs().max())).item()


def test_tf32_fragments_pair_a_columns_with_b_rows():
    """ldmatrix's four 8 x 4 fp32 matrices are the m16n8k8 tf32 A fragment
    in its own k order (A columns t, t + 4), and B is loaded at rows t,
    t + 4: each k index stands for the same channel in both; B loaded in the
    attention kernels' paired order misses the limit by far."""
    assert KERNEL_ORDER == (list(range(8)), list(range(8)))
    x, w, ref = _conv_case(0)
    assert _share(_tf32x3_conv(x, w, order=PAIRED_B_ORDER), ref) > 100.0


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32x3_tap_partials_keep_truncated_sums_within_the_limit(seed):
    """Why the kernel sums each tap's products in a zeroed partial: over
    K = 1728 (216 k-steps, 648 mma) one chain of truncated sums spends about
    the whole fp32 limit (1e-5 of the largest |plain|), the tap partials
    (24 mma each, added to nearest) stay within a quarter of it; one tf32
    rounding of each operand would miss it by far."""
    x, w, ref = _conv_case(seed)
    partials = _share(_tf32x3_conv(x, w), ref)
    chained = _share(_tf32x3_conv(x, w, tap_partials=False), ref)
    assert partials <= FP32_MARGIN, partials
    assert chained > 0.5 and chained > 5 * partials, (chained, partials)
    assert _share(_tf32x3_conv(x, w, split=False), ref) > 10.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_edge_shapes_match_plain_with_the_same_bits(shape, dtype):
    """W = 8 with C = 3 and Cout = 5 (the kernel's element-wise copies), one
    plane (both halo planes zero), B * D at its cap of 65,535 and Cout > 64
    (channel tiles on grid.y): within the limits of the plain version, the
    same bits on a second run, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    x, w = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
            for a in _inputs(shape, seed=sum(shape)))
    before = tconv.conv3d_igemm.launches
    out, again = tconv.conv3d_igemm(x, w), tconv.conv3d_igemm(x, w)
    torch.cuda.synchronize()
    assert tconv.conv3d_igemm.launches == before + 2
    assert torch.equal(out, again)
    ref = tconv.conv3d_ref(x, w).float()
    rel = 2.0**-7 if dtype == "bfloat16" else 1e-5
    assert (out.float() - ref).abs().max().item() <= rel * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_kernel_runs_the_tensor_core_kernel_by_name():
    """bf16 launches conv3d_igemm_wgmma_kernel and fp32
    conv3d_igemm_tf32x3_kernel (the profiler's trace), and nothing of cuDNN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for dt, kernel in ((torch.bfloat16, "conv3d_igemm_wgmma_kernel"),
                       (torch.float32, "conv3d_igemm_tf32x3_kernel")):
        x, w = (torch.from_numpy(a).to("cuda", dt) for a in _inputs((1, 2, 8, 32, 64, 64), 3))
        tconv.conv3d_igemm(x, w)
        torch.cuda.synchronize()
        # a trace that lost its device events (seen with torch 2.11) is taken again
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tconv.conv3d_igemm(x, w)
                torch.cuda.synchronize()
            names = [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
            if names:
                break
        assert any(kernel in k for k in names), names
        assert not any("cudnn" in k.lower() or "conv" in k.lower() and "igemm" not in k
                       for k in names), names
