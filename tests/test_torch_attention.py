"""Parity of the port's attention (``ldm3d_torch/ops/attention.py``) with the
JAX package's (``ldm3d_tpu/ops/attention.py``).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs its Pallas flash kernels in interpret mode (both the k/v-resident B1
kernel and, with ``_MONO_KV_BYTES`` forced to 0, the streamed B2 kernel) or
its XLA reference. Inputs are made with numpy from a seed. Tolerance: atol
1e-5 in fp32 on O and LSE (summation order only). The wrapper's device rule
and the CUDA kernel itself are tested in ``tests/test_torch_kernels.py``.
"""

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
