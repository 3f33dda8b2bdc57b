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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
