"""Parity of the port's attention gradient with the JAX package's.

The port's ``volumetric_attention`` is ``FlashAttention``; on the CPU its
backward runs the plain PyTorch dQ and dK/dV (``attention_bwd_dq_reference``,
``attention_bwd_dkv_reference``), the same FlashAttention-2 formulas the CUDA
kernels of ``csrc/flash_bwd.cu`` compute. The JAX side is ``jax.grad`` of
``volumetric_attention(..., use_flash=True, interpret=True)``: its Pallas
forward (the k/v-resident kernel, or the streamed one with ``_MONO_KV_BYTES``
forced to 0) and its Pallas dQ and dK/dV kernels in interpret mode; token
counts the Pallas kernels cannot tile go through its XLA attention. Inputs
and the output cotangent are made with numpy from a seed. Tolerance: atol
1e-5 in fp32 (summation order only).

The bf16 tensor-core kernels round where the fp32 plain version does not:
they split P and dS into bf16 hi and lo parts before the three products.
:func:`_bf16_bwd_emulation` repeats their arithmetic in plain torch, so its
precision is held here, where no card is present, to a margin inside the
card's limit (one bf16 ulp of the largest |grad|, 2^-7 of it): 0.75 of it.
``PYTHONPATH=. python tests/test_torch_attention_grad.py`` prints the share of
the limit at the card's shapes, with the hi-lo split and with one rounding.

The fp32 tensor-core kernels split every operand into tf32 hi and lo parts
(3xTF32); :func:`_tf32x3_bwd_emulation` repeats that arithmetic, held to 0.25
of the card's fp32 limit (1e-4 of the largest |grad|), and with the tensor
cores' truncated mma sums it shows why each tile's products are summed in a
partial of their own.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch.nn.functional as F
from test_torch_attention import _frag_mm, _k_order, _tf32_rna, _tf32_trunc

import ldm3d_tpu.ops.attention as jattn
from ldm3d_torch.ops import attention as tattn

ATOL = 1e-5


def _inputs(shape, seed, kv_len=None):
    rng = np.random.default_rng(seed)
    b, n, h, d = shape
    kv = (b, kv_len or n, h, d)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(kv, dtype=np.float32),
            rng.standard_normal(kv, dtype=np.float32),
            rng.standard_normal(shape, dtype=np.float32))


def _port_grads(q, k, v, g):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.volumetric_attention(qt, kt, vt)
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _jax_grads(attn, q, k, v, g):
    def loss(q, k, v):
        return jnp.sum(attn(q, k, v) * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))]


@pytest.mark.parametrize("shape,block", [
    ((2, 64, 2, 64), 32),     # UNet-like multi-head, 2 q blocks x 2 kv blocks
    ((1, 96, 1, 8), 32),      # head_dim 8 (JAX lane-pads to 64 outside its kernels)
    ((2, 40, 3, 40), 8),      # head_dim 40, 5 blocks
    ((1, 64, 1, 256), 32),    # head_dim 256, the VAE's single head
])
def test_grads_match_jax_flash_mono(shape, block):
    q, k, v, g = _inputs(shape, seed=shape[1] + shape[3])

    def attn(q, k, v):
        return jattn.volumetric_attention(q, k, v, use_flash=True, interpret=True,
                                          block_q=block, block_k=block)

    for name, got, want in zip("qkv", _port_grads(q, k, v, g), _jax_grads(attn, q, k, v, g)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_grads_match_jax_flash_streamed(monkeypatch):
    """The streamed (k/v tiles over an inner grid axis) forward kernel before
    the dQ/dK/dV kernels, reached by forcing the resident-k/v budget to 0."""
    monkeypatch.setattr(jattn, "_MONO_KV_BYTES", 0)
    q, k, v, g = _inputs((1, 72, 2, 64), seed=11)

    def attn(q, k, v):
        return jattn.volumetric_attention(q, k, v, use_flash=True, interpret=True,
                                          block_q=24, block_k=24)

    for name, got, want in zip("qkv", _port_grads(q, k, v, g), _jax_grads(attn, q, k, v, g)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("n,kv_len", [(125, 125), (100, 37)])
def test_grads_ragged_match_xla(n, kv_len):
    """Token counts with no multiple-of-8 divisor (the UNet's 5^3 level), which
    the Pallas kernels cannot tile: the port takes them, held against
    ``jax.grad`` of the XLA attention."""
    q, k, v, g = _inputs((2, n, 2, 64), seed=n, kv_len=kv_len)
    for name, got, want in zip("qkv", _port_grads(q, k, v, g),
                               _jax_grads(jattn._xla_attention, q, k, v, g)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_backward_pieces_match_jax_kernels():
    """dQ and (dK, dV) of the port's plain versions, given the forward's LSE
    and D, against the JAX package's ``_flash_bwd_impl`` (its Pallas dQ and
    dK/dV kernels in interpret mode) on the same residuals."""
    q, k, v, g = _inputs((2, 48, 2, 64), seed=5)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jlse = jattn._flash_fwd_impl(jq, jk, jv, 16, 16, interpret=True)
    ref = jattn._flash_bwd_impl(jq, jk, jv, jo, jlse, jg, 16, 16, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    to = torch.from_numpy(np.array(jo))
    tlse = torch.from_numpy(np.array(jlse)[..., 0])
    got = tattn.flash_attention_bwd(tq, tk, tv, to, tlse, tg)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                   err_msg=f"d{name}")


# --- the bf16 tensor-core backward's arithmetic (csrc/flash_bwd.cu)

BF16_REL = 2.0**-7      # the card's limit: one bf16 ulp of the largest |grad|
MARGIN = 0.75           # the emulation stays this far inside it
LOG2E = 1.4426950408889634


def _bf16_bwd_emulation(q, k, v, do, lse, dvec, split=True):
    """The arithmetic of ``flash_bwd_dq_bf16_mma_kernel`` and
    ``flash_bwd_dkv_bf16_mma_kernel`` in plain torch: bf16 q, k, v, dO;
    S = q k^T and dP = dO v^T in fp32 (products of bf16 values are exact in
    fp32); P = exp2(S * scale * log2(e) - LSE * log2(e)) with the scale and
    log2(e) folded into one fp32 factor; dS = P * (dP - D); P and dS split
    into hi = bf16(x) and lo = bf16(x - hi) (with ``split=False`` only hi,
    one rounding), each part multiplied in fp32; dQ and dK times the scale
    and every output rounded to bf16 once. Returns ``(dq, dk, dv)``."""
    b, n, h, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf, of = (t.float().transpose(1, 2) for t in (q, k, v, do))
    nl = -(lse.reshape(b, h, n, 1) * torch.tensor(LOG2E, dtype=torch.float32))
    p = torch.exp2(qf @ kf.transpose(-1, -2) * c + nl)
    ds = p * (of @ vf.transpose(-1, -2) - dvec.reshape(b, h, n, 1))

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        return (hi, (x - hi).to(torch.bfloat16).float()) if split else (hi,)

    dq = sum(a @ kf for a in parts(ds)) * scale
    dk = sum(a.transpose(-1, -2) @ qf for a in parts(ds)) * scale
    dv = sum(a.transpose(-1, -2) @ of for a in parts(p))
    return tuple(x.transpose(1, 2).to(torch.bfloat16) for x in (dq, dk, dv))


def _bf16_case(shape, seed):
    """bf16 q, k, v, dO from numpy draws; the plain forward's O and LSE and
    D = rowsum(dO * O), as the kernels receive them."""
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(shape, seed))
    out, lse = tattn.attention_reference(q, k, v)
    return q, k, v, g, out, lse, tattn.attention_bwd_dvec(g, out)


def _shares_of_limit(got, want):
    """Each gradient's largest error as a share of 2^-7 of its largest |grad|."""
    return [((a.float() - b.float()).abs().max() / (BF16_REL * b.float().abs().max())).item()
            for a, b in zip(got, want)]


def _emulated_shares(shape, seed, split=True):
    q, k, v, g, out, lse, dvec = _bf16_case(shape, seed)
    refs = tattn.attention_bwd_reference(q, k, v, out, lse, g)
    return _shares_of_limit(_bf16_bwd_emulation(q, k, v, g, lse, dvec, split), refs)


# (shape, seed): the UNet's training shapes (level 2 at batch 20, level 1 at
# a reduced batch), d = 40 (not a multiple of 16, ragged n) and the VAE's
# d = 256, several seeds each
EMULATION_CASES = ([((20, 125, 16, 64), s) for s in range(3)]
                   + [((2, 1000, 8, 64), s) for s in range(2)]
                   + [((2, 100, 3, 40), s) for s in range(4)]
                   + [((1, 64, 1, 256), s) for s in range(4)])


@pytest.mark.parametrize("shape,seed", EMULATION_CASES)
def test_bf16_bwd_emulation_within_margin_of_plain(shape, seed):
    """The split keeps dq, dk and dv within 0.75 of the card's limit of the
    fp32 plain version on the same bf16 inputs."""
    for name, share in zip(("dq", "dk", "dv"), _emulated_shares(shape, seed)):
        assert share <= MARGIN, (name, share)


def test_single_rounding_would_not_keep_the_margin():
    """Why the kernels split P and dS: rounding each once to bf16 takes dv
    of the VAE's d = 256 attention to 0.99 of the card's limit on this seed,
    past the margin; the split keeps it at 0.12."""
    shape, seed = (1, 64, 1, 256), 1
    assert _emulated_shares(shape, seed, split=False)[2] > MARGIN
    assert max(_emulated_shares(shape, seed)) <= MARGIN


@pytest.mark.parametrize("shape,kv_len,long", [
    ((1, 16, 1, 64), 8000, (0,)),      # dQ's chain over 8000 keys, 32-key tiles
    ((1, 16, 1, 256), 8000, (0,)),     # the same at d = 256, 16-key tiles
    ((1, 8000, 1, 64), 16, (1, 2)),    # dK/dV's chains over 8000 queries
])
def test_tf32x3_bwd_partials_keep_truncated_mma_sums_within_the_limit(shape, kv_len, long):
    """Why the kernels sum each tile's products in a zeroed partial: the
    tensor cores truncate each mma's sum toward zero, and one chain of
    thousands of mma on the accumulator (3 a k-step of 8, over 8000 keys or
    queries) spends most of the fp32 limit on the long-chained outputs; in
    the kernels' partials, added to the accumulator to nearest, they stay
    inside the margin."""
    chained = _fp32_emulated_shares(shape, 0, kv_len, truncate="chained")
    partials = _fp32_emulated_shares(shape, 0, kv_len, truncate="partials")
    assert max(partials) <= FP32_MARGIN, partials
    for out in long:
        assert chained[out] > 0.5 and chained[out] > 10 * partials[out], (chained, partials)


@pytest.mark.parametrize("shape,block", [
    ((2, 128, 2, 64), 64),    # UNet-like heads, two q and two kv blocks
    ((1, 64, 1, 256), 32),    # the VAE's single d = 256 head
    ((2, 40, 3, 40), 8),      # head_dim 40, five blocks
])
def test_bf16_bwd_emulation_matches_jax_kernels(shape, block):
    """The same bf16 values, in fp32, through the JAX package's Pallas dQ and
    dK/dV kernels (``_flash_bwd_impl`` in interpret mode) on the same O and
    LSE: the emulation is within 0.75 of the card's limit of them too."""
    q, k, v, g, out, lse, dvec = _bf16_case(shape, seed=shape[1] + shape[3])
    got = _bf16_bwd_emulation(q, k, v, g, lse, dvec)
    jq, jk, jv, jg, jo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, g, out))
    ref = jattn._flash_bwd_impl(jq, jk, jv, jo, jnp.asarray(lse.numpy())[..., None], jg,
                                block, block, interpret=True)
    for name, share in zip(("dq", "dk", "dv"), _shares_of_limit(
            got, [torch.from_numpy(np.array(x)) for x in ref])):
        assert share <= MARGIN, (name, share)


# --- the fp32 tensor-core backward's arithmetic (csrc/flash_bwd.cu): 3xTF32

FP32_REL = 1e-4         # the card's limit: 1e-4 of the largest |grad| of each output
FP32_MARGIN = 0.25      # the emulation stays this far inside it

# S = Q K^T in dQ and S^T = K Q^T, dP^T = V dO^T in dK/dV: scalar loads of
# A rows g, g + 8 and B row g at head dims t, t + 4
STD_ORDER = _k_order(lambda g, t: [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)],
                     lambda g, t: [t, t + 4])
# dP = dO V^T in dQ: float2 loads of dO rows g, g + 8 and V row g at head
# dims 2t, 2t + 1
DP_ORDER = _k_order(lambda g, t: [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t + 1)],
                    lambda g, t: [2 * t, 2 * t + 1])
# dQ += dS K: dS's A registers are S's C registers c0, c2, c1, c3 (C[g][2t],
# C[g+8][2t], C[g][2t+1], C[g+8][2t+1]); K rows (keys) 2t, 2t + 1 at column g
DS_K_ORDER = _k_order(lambda g, t: [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1),
                                    (g + 8, 2 * t + 1)],
                      lambda g, t: [2 * t, 2 * t + 1])
# dV += P^T dO and dK += dS^T Q: P^T and dS^T from the C registers of S^T and
# dP^T the same way; dO and Q rows (queries) 2t, 2t + 1 at column g
PT_DO_ORDER = _k_order(lambda g, t: [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1),
                                     (g + 8, 2 * t + 1)],
                       lambda g, t: [2 * t, 2 * t + 1])
DST_Q_ORDER = PT_DO_ORDER
BWD_ORDERS = {"s": STD_ORDER, "dp": DP_ORDER, "ds_k": DS_K_ORDER, "pt_do": PT_DO_ORDER,
              "dst_q": DST_Q_ORDER}


def _pad_k(a, b):
    """a (..., m, k) and b (..., k, n) zero-padded along k to a multiple of 8
    (keys or queries past the edge: the kernels load zero rows and mask P)."""
    pad = -a.shape[-1] % 8
    return F.pad(a, (0, pad)), F.pad(b, (0, 0, 0, pad))


def _rz_fp32(x):
    """float64 to fp32, rounded toward zero: how an mma's sum is stored."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _frag_mm_truncated(a, b, order, tile=None):
    """a @ b as the kernels chain their mma: per step of 8 along k (in the
    ``order`` of the fragment loads) the three products lo*hi, hi*lo, hi*hi
    are each added to the accumulator exactly and the sum truncated toward
    zero to fp32, as the tensor cores store it. With ``tile``, the chain
    restarts from a zeroed partial every ``tile`` k, and each partial is
    added to the fp32 result to nearest (acc_tile_tf32x3); without it one
    chain runs over all of k."""
    a_cols, b_rows = order
    k = a.shape[-1]
    idx_a = (torch.arange(0, k, 8)[:, None] + torch.tensor(a_cols)).reshape(-1)
    idx_b = (torch.arange(0, k, 8)[:, None] + torch.tensor(b_rows)).reshape(-1)
    a, b = a[..., idx_a], b[..., idx_b, :]
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    parts = [(x.double(), y.double()) for x, y in ((al, bh), (ah, bl), (ah, bh))]
    out = part = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32)
    for s in range(0, k, 8):
        for x, y in parts:
            part = _rz_fp32(part.double() + x[..., s:s + 8] @ y[..., s:s + 8, :])
        if tile is not None and ((s + 8) % tile == 0 or s + 8 >= k):
            out, part = out + part, torch.zeros_like(part)
    return part if tile is None else out


def _tf32x3_bwd_emulation(q, k, v, do, lse, dvec, split=True, orders=BWD_ORDERS,
                          truncate=None):
    """The arithmetic of ``flash_bwd_dq_tf32x3_mma_kernel`` and
    ``flash_bwd_dkv_tf32x3_mma_kernel`` in plain torch: each product in mma
    steps of 8 along its k dimension, in the k order of the kernels' fragment
    loads (``orders``), each operand split into tf32 hi (to nearest) and lo
    (the truncated remainder) and three products summed (with
    ``split=False``, each operand rounded once); P = exp2(S * c - LSE *
    log2(e)) with c = scale * log2(e) in fp32, in one fma; dS = P * (dP - D);
    dQ and dK times the scale. Each product is summed to nearest, unless
    ``truncate`` chains its mma with truncated sums (``_frag_mm_truncated``):
    S and dP over the head dims of one tile, and dQ, dK, dV either over all
    keys or queries (``"chained"``) or in the kernels' partials of one tile
    (``"partials"``: BN keys for dQ, BM queries for dK/dV). Returns ``(dq,
    dk, dv)``, fp32."""
    b, n, h, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    c = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf, of = (t.transpose(1, 2) for t in (q, k, v, do))
    nl = -(lse.reshape(b, h, n, 1) * torch.tensor(LOG2E, dtype=torch.float32))
    if truncate is None:
        def mm(a, b, key, tile=None):
            return _frag_mm(a, b, orders[key], split)
    else:
        def mm(a, b, key, tile=None):
            return _frag_mm_truncated(a, b, orders[key], tile if truncate == "partials" else None)
    s = mm(qf, kf.transpose(-1, -2), "s")
    dp = mm(of, vf.transpose(-1, -2), "dp")
    p = torch.exp2((s.double() * c.double() + nl.double()).float())
    ds = p * (dp - dvec.reshape(b, h, n, 1))
    # the kernels' tiles (DqTf32::BN keys, DkvTf32::BM queries)
    dq_tile, dkv_tile = (16 if d > 128 else 32), (32 if d <= 64 else 16)
    dq = mm(*_pad_k(ds, kf), "ds_k", dq_tile) * scale
    dv = mm(*_pad_k(p.transpose(-1, -2), of), "pt_do", dkv_tile)
    dk = mm(*_pad_k(ds.transpose(-1, -2), qf), "dst_q", dkv_tile) * scale
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _fp32_case(shape, seed, kv_len=None):
    """fp32 q, k, v, dO from numpy draws; the plain forward's O and LSE and
    D = rowsum(dO * O), as the kernels receive them."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(shape, seed, kv_len))
    out, lse = tattn.attention_reference(q, k, v)
    return q, k, v, g, out, lse, tattn.attention_bwd_dvec(g, out)


def _fp32_shares(got, want):
    """Each gradient's largest error as a share of 1e-4 of its largest |grad|."""
    return [((a - b).abs().max() / (FP32_REL * b.abs().max())).item()
            for a, b in zip(got, want)]


def _fp32_emulated_shares(shape, seed, kv_len=None, **kwargs):
    q, k, v, g, out, lse, dvec = _fp32_case(shape, seed, kv_len)
    refs = tattn.attention_bwd_reference(q, k, v, out, lse, g)
    return _fp32_shares(_tf32x3_bwd_emulation(q, k, v, g, lse, dvec, **kwargs), refs)


def test_tf32_bwd_fragment_orders():
    """Each product's A and B operands stand for the same head dim, key or
    query at every k index: S takes dims t, t + 4 (K is also read along keys,
    so it is read as scalars), dP dims 2t, 2t + 1 (float2 loads), and the
    three products fed from accumulators take keys or queries 2t, 2t + 1 for
    t, t + 4, so their B rows are loaded in that order."""
    assert STD_ORDER == (list(range(8)), list(range(8)))
    for order in (DP_ORDER, DS_K_ORDER, PT_DO_ORDER, DST_Q_ORDER):
        assert order[0] == order[1] == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("shape,seed", [((2, 125, 16, 64), 0), ((2, 125, 16, 64), 1),
                                        ((1, 1000, 1, 64), 0), ((2, 100, 3, 40), 0),
                                        ((2, 100, 3, 40), 1), ((1, 64, 1, 256), 0),
                                        ((1, 64, 1, 256), 1)])
def test_tf32x3_bwd_emulation_within_quarter_of_the_fp32_limit(shape, seed):
    """The split keeps dq, dk and dv within 0.25 of the card's fp32 limit
    (1e-4 of each output's largest |grad|) of the plain fp32 backward."""
    for name, share in zip(("dq", "dk", "dv"), _fp32_emulated_shares(shape, seed)):
        assert share <= FP32_MARGIN, (name, share)


def test_one_tf32_rounding_or_a_wrong_key_order_breaks_the_fp32_limit():
    """Why the split: with each operand rounded once to tf32 a gradient
    misses the 1e-4 limit; and each accumulator-fed product's key order pins
    its fragment mapping (B rows loaded as t, t + 4 miss by far more)."""
    shape, seed = (1, 1000, 1, 64), 0
    assert max(_fp32_emulated_shares(shape, seed, split=False)) > 1.0
    unpermuted = (DS_K_ORDER[0], list(range(8)))
    for key, out in (("ds_k", 0), ("pt_do", 2), ("dst_q", 1)):
        shares = _fp32_emulated_shares(shape, seed, orders={**BWD_ORDERS, key: unpermuted})
        assert shares[out] > 100.0, (key, shares)


@pytest.mark.parametrize("shape,block", [
    ((2, 128, 2, 64), 64),    # UNet-like heads, two q and two kv blocks
    ((1, 64, 1, 256), 32),    # the VAE's single d = 256 head
    ((2, 40, 3, 40), 8),      # head_dim 40, five blocks
])
def test_tf32x3_bwd_emulation_matches_jax_kernels(shape, block):
    """The emulation against ``jax.grad`` of the JAX package's flash
    attention (its Pallas forward, dQ and dK/dV kernels in interpret mode),
    atol 1e-5."""
    q, k, v, g = _inputs(shape, seed=shape[1] + shape[3])

    def attn(q, k, v):
        return jattn.volumetric_attention(q, k, v, use_flash=True, interpret=True,
                                          block_q=block, block_k=block)

    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = tattn.attention_reference(tq, tk, tv)
    got = _tf32x3_bwd_emulation(tq, tk, tv, tg, lse, tattn.attention_bwd_dvec(tg, out))
    for name, a, want in zip("qkv", got, _jax_grads(attn, q, k, v, g)):
        np.testing.assert_allclose(a.numpy(), want, atol=ATOL, rtol=0, err_msg=f"d{name}")


if __name__ == "__main__":
    # the emulated share of the card's bf16 limit, split and single rounding,
    # at the test cases and at the VAE's (1, 8000, 1, 256) (about 3 GB)
    for shape, seed in EMULATION_CASES + [((1, 8000, 1, 256), s) for s in range(2)]:
        split = _emulated_shares(shape, seed)
        single = _emulated_shares(shape, seed, split=False)
        print(shape, seed, "split dq/dk/dv", [f"{x:.3f}" for x in split],
              "single", [f"{x:.3f}" for x in single])
