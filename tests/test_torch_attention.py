"""Parity of the port's attention (``ldm3d_torch/ops/attention.py``) with the
JAX package's (``ldm3d_tpu/ops/attention.py``).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs its Pallas flash kernels in interpret mode (both the k/v-resident B1
kernel and, with ``_MONO_KV_BYTES`` forced to 0, the streamed B2 kernel) or
its XLA reference. Inputs are made with numpy from a seed. Tolerance: atol
1e-5 in fp32 on O and LSE (summation order only). The wrapper's device rule
and the CUDA kernel itself are tested in ``tests/test_torch_kernels.py``.

The bf16 tensor-core kernel rounds once more than the fp32 plain version: P
to bf16 before P·V. :func:`_bf16_kernel_emulation` repeats its arithmetic in
plain torch, so its precision is held here, where no card is present, to the
limits the card is held to: O within 2^-7 of max|O| (one bf16 ulp of the
largest output), LSE within 1e-4.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldm3d_tpu.ops.attention as jattn
from ldm3d_torch.ops import attention as tattn

torch.set_num_threads(1)

ATOL = 1e-5


def _qkv(shape, seed, kv_len=None):
    rng = np.random.default_rng(seed)
    b, n, h, d = shape
    kv_shape = (b, kv_len or n, h, d)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32))


def _port(q, k, v):
    out, lse = tattn.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("shape,block", [
    ((2, 64, 2, 64), 32),     # UNet-like multi-head, 2 q blocks x 2 kv blocks
    ((1, 96, 1, 8), 32),      # head_dim 8 (true scale; JAX lane-pads to 64)
    ((1, 48, 3, 16), 16),     # head_dim 16
    ((2, 40, 2, 32), 8),      # head_dim 32, 5 blocks
])
def test_plain_matches_jax_flash_mono(shape, block):
    q, k, v = _qkv(shape, seed=shape[1] + shape[3])
    out, lse = _port(q, k, v)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jattn.volumetric_attention(jq, jk, jv, use_flash=True, interpret=True,
                                     block_q=block, block_k=block)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)
    if shape[3] % 64 == 0:  # LSE is comparable where the JAX kernel runs unpadded
        _, ref_lse = jattn._flash_fwd_impl(jq, jk, jv, block, block, interpret=True)
        np.testing.assert_allclose(lse, np.asarray(ref_lse)[..., 0], atol=ATOL, rtol=0)


def test_plain_matches_jax_flash_streamed(monkeypatch):
    """The streamed (k/v tiles over an inner grid axis) B2 kernel, reached by
    forcing the resident-k/v budget to 0 on a shape no other test traces."""
    monkeypatch.setattr(jattn, "_MONO_KV_BYTES", 0)
    shape = (1, 72, 2, 64)
    q, k, v = _qkv(shape, seed=11)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_out, ref_lse = jattn._flash_fwd_impl(jq, jk, jv, 24, 24, interpret=True)
    out, lse = _port(q, k, v)
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse, np.asarray(ref_lse)[..., 0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,kv_len", [(125, 125), (100, 37)])
def test_plain_ragged_matches_xla(n, kv_len):
    """Token counts with no multiple-of-8 divisor (the UNet's 5^3 level), which
    the Pallas kernels cannot tile: the port takes them, held against XLA."""
    q, k, v = _qkv((2, n, 2, 64), seed=n, kv_len=kv_len)
    out, lse = _port(q, k, v)
    ref = jattn._xla_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL, rtol=0)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 8.0
    ref_lse = np.log(np.exp(logits).sum(-1)).reshape(2 * 2, n)
    np.testing.assert_allclose(lse, ref_lse, atol=ATOL, rtol=0)


def _bf16_kernel_emulation(q, k, v, block_k):
    """The arithmetic of ``flash_fwd_bf16_mma_kernel`` in plain torch: bf16
    q, k, v; S = q k^T in fp32 (products of bf16 values are exact in fp32);
    for each tile of ``block_k`` keys the online softmax in the log2 domain
    (running max m of S * scale * log2(e), P = exp2(S * scale * log2(e) - m)
    in fp32, row sums of the fp32 P) and O += P V with P rounded to bf16 and
    fp32 accumulation; O = acc / l rounded to bf16, LSE = (m + log2 l) ln 2.
    Returns ``(O, LSE)`` as the wrapper does."""
    b, n, h, d = q.shape
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    m = torch.full((b, h, n), -math.inf)
    l = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, d))
    for j0 in range(0, kf.shape[2], block_k):
        s = qf @ kf[:, :, j0:j0 + block_k].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, j0:j0 + block_k]
        m = m_new
    out = (acc / l[..., None]).to(torch.bfloat16).transpose(1, 2)
    lse = (m + torch.log2(l)) * math.log(2.0)
    return out, lse.reshape(b * h, n)


@pytest.mark.parametrize("shape,kv_len,jax_block", [
    ((2, 128, 2, 64), None, 64),     # UNet-like heads, two kv tiles; JAX interpret kernel
    ((1, 64, 1, 256), None, 32),     # the VAE's single d = 256 head, two kv tiles of 32
    ((2, 100, 3, 40), None, None),   # d not a multiple of 16, ragged n: JAX's XLA path
    ((2, 100, 2, 64), 37, None),     # kv_len != n, one ragged kv tile
])
def test_bf16_kernel_rounding_within_card_limits(shape, kv_len, jax_block):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(shape, seed=shape[1] + shape[3], kv_len=kv_len))
    out, lse = _bf16_kernel_emulation(q, k, v, block_k=32 if shape[3] > 128 else 64)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    assert out.dtype == ref.dtype == torch.bfloat16
    tol = 2.0**-7 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    # the same bf16 values, in fp32, through the JAX package's forward
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    if jax_block is not None:
        jout, jlse = jattn._flash_fwd_impl(jq, jk, jv, jax_block, jax_block, interpret=True)
        jlse = np.asarray(jlse)[..., 0]
    else:
        jout = jattn._xla_attention(jq, jk, jv)
        logits = np.einsum("bqhd,bkhd->bhqk", np.asarray(jq, np.float64),
                           np.asarray(jk, np.float64)) / math.sqrt(shape[3])
        jlse = np.log(np.exp(logits).sum(-1)).reshape(-1, shape[1])
    jout = np.asarray(jout)
    assert np.abs(out.float().numpy() - jout).max() <= 2.0**-7 * np.abs(jout).max()
    assert np.abs(lse.numpy() - jlse).max() <= 1e-4


# --- the fp32 tensor-core forward (flash_fwd_tf32x3_mma_kernel): 3xTF32 ----

def _tf32_rna(x):
    """x rounded to tf32, to nearest with ties away from zero (split_tf32's hi)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _k_order(a_regs, b_regs):
    """The source column of A and the source row of B that each k index of an
    m16n8k8 tf32 mma stands for, from a kernel's registers. ``a_regs(g, t)``
    gives the (row, column) of the source tile that lane 4g + t puts in
    a0..a3, which the tensor core reads as A[g][t], A[g+8][t], A[g][t+4],
    A[g+8][t+4]; ``b_regs(g, t)`` the source row of b0, b1 (column g), read
    as B[t][g], B[t+4][g]. Checks that A's rows are the source's rows."""
    a_col, b_row = {}, {}
    for lane in range(32):
        g, t = divmod(lane, 4)
        for (row, col), (r, k) in zip(a_regs(g, t), ((g, t), (g + 8, t), (g, t + 4),
                                                      (g + 8, t + 4))):
            assert row == r
            assert a_col.setdefault(k, col) == col
        for src, k in zip(b_regs(g, t), (t, t + 4)):
            assert b_row.setdefault(k, src) == src
    return [a_col[k] for k in range(8)], [b_row[k] for k in range(8)]


# S = Q K^T: float2 loads of Q rows g, g + 8 and K row g at head dims 2t, 2t + 1
S_ORDER = _k_order(lambda g, t: [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t + 1)],
                   lambda g, t: [2 * t, 2 * t + 1])
# O += P V: P's A registers are S's C registers c0, c2, c1, c3 (C[g][2t],
# C[g+8][2t], C[g][2t+1], C[g+8][2t+1]); V rows 2t, 2t + 1 at column g
PV_ORDER = _k_order(lambda g, t: [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t + 1)],
                    lambda g, t: [2 * t, 2 * t + 1])


def _frag_mm(a, b, order, split):
    """a @ b as the kernel's mma steps: each group of 8 along k in the A and B
    orders ``order``, and each operand split (3xTF32: lo*hi + hi*lo + hi*hi)
    or rounded once (1xTF32)."""
    a_cols, b_rows = order
    k = a.shape[-1]
    idx_a = (torch.arange(0, k, 8)[:, None] + torch.tensor(a_cols)).reshape(-1)
    idx_b = (torch.arange(0, k, 8)[:, None] + torch.tensor(b_rows)).reshape(-1)
    a, b = a[..., idx_a], b[..., idx_b, :]
    if not split:
        return _tf32_rna(a) @ _tf32_rna(b)
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_kernel_emulation(q, k, v, split=True, order=PV_ORDER):
    """The arithmetic of ``flash_fwd_tf32x3_mma_kernel`` in plain torch: S in
    mma steps over 8 head dims (S_ORDER); per tile of 64 keys (32 at d > 128)
    the online softmax in the log2 domain with scale * log2(e) folded into one
    fma, fp32 row sums of P; O += P V in mma steps over 8 keys in ``order``.
    Returns ``(O, LSE)`` as the wrapper does."""
    b, n, h, d = q.shape
    block_k = 32 if d > 128 else 64
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
    m = torch.full((b, h, n), -math.inf)
    l = torch.zeros((b, h, n))
    acc = torch.zeros((b, h, n, d))
    kv = kf.shape[2]
    for j0 in range(0, kv, block_k):
        kt, vt = kf[:, :, j0:j0 + block_k], vf[:, :, j0:j0 + block_k]
        pad = block_k - kt.shape[2]  # keys past kv_len: zero rows, masked scores
        kt, vt = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (kt, vt))
        s = _frag_mm(qf, kt.transpose(-1, -2), S_ORDER, split)
        s[..., block_k - pad:] = -math.inf
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2((s.double() * c.double() - m_new[..., None].double()).float())
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _frag_mm(p, vt, order, split)
        m = m_new
    out = (acc / l[..., None]).transpose(1, 2)
    return out, ((m + torch.log2(l)) * math.log(2.0)).reshape(b * h, n)


def test_tf32_fragment_orders_agree():
    """The kernel's A and B operands stand for the same head dim (S) and the
    same key (P V) at every k index: S's float2 loads keep dims 2t, 2t + 1
    together, and P feeds back from S's accumulators in place, so V must be
    loaded as rows 2t, 2t + 1 (an unpermuted V load, rows t and t + 4,
    would pair P of key 2t with V of key t)."""
    assert S_ORDER[0] == S_ORDER[1] == PV_ORDER[0] == PV_ORDER[1] == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape,kv_len", [((2, 125, 16, 64), None), ((1, 1000, 1, 64), None),
                                          ((1, 64, 1, 256), None), ((1, 100, 2, 64), 37)])
def test_tf32x3_kernel_arithmetic_within_quarter_of_the_fp32_limit(shape, kv_len, seed):
    """The split keeps the kernel's O and LSE within 0.25 of the fp32 limit
    (1e-4) of the plain version on randn inputs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed=seed, kv_len=kv_len))
    out, lse = _tf32_kernel_emulation(q, k, v)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    assert (out - ref).abs().max().item() <= 0.25e-4
    assert (lse - ref_lse).abs().max().item() <= 0.25e-4


def test_one_tf32_rounding_would_break_the_fp32_limit():
    """Why the split: with each operand rounded once to tf32, O or the LSE
    misses the 1e-4 limit at (1, 1000, 1, 64); and the P V key order pins
    the fragment mapping (V loaded as rows t, t + 4 misses it by far)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1000, 1, 64), seed=0))
    ref, ref_lse = tattn.attention_reference(q, k, v)
    out, lse = _tf32_kernel_emulation(q, k, v, split=False)
    assert max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item()) > 1e-4
    unpermuted_v = (PV_ORDER[0], list(range(8)))
    out, _ = _tf32_kernel_emulation(q, k, v, order=unpermuted_v)
    assert (out - ref).abs().max().item() > 1e-2


# --- head widths that are not a multiple of 8, and above 256 (C2) ---------

@pytest.mark.parametrize("d", [36, 320])
def test_volumetric_attention_pads_heads_and_matches_jax_with_grads(d):
    """The port's volumetric_attention at d = 36 (padded to 40 outside the
    autograd Function, sliced after) and d = 320, forward and the gradients of
    q, k, v, against the JAX package's flash path in interpret mode (which
    pads to 64 and 320), atol 1e-5."""
    import jax

    shape = (1, 24, 2, d)
    q, k, v = _qkv(shape, seed=d)
    w = np.random.default_rng(d + 1).standard_normal(shape, dtype=np.float32)

    def jloss(q, k, v):
        out = jattn.volumetric_attention(q, k, v, use_flash=True, interpret=True,
                                         block_q=8, block_k=8)
        return (out * w).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.volumetric_attention(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
