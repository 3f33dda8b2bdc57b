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
