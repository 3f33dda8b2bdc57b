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
"""

import math

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


if __name__ == "__main__":
    # the emulated share of the card's bf16 limit, split and single rounding,
    # at the test cases and at the VAE's (1, 8000, 1, 256) (about 3 GB)
    for shape, seed in EMULATION_CASES + [((1, 8000, 1, 256), s) for s in range(2)]:
        split = _emulated_shares(shape, seed)
        single = _emulated_shares(shape, seed, split=False)
        print(shape, seed, "split dq/dk/dv", [f"{x:.3f}" for x in split],
              "single", [f"{x:.3f}" for x in single])
