"""The attention wrapper's rules and the CUDA kernel against its plain version.

No JAX here: this file also runs on the machine with the card, where the
``cuda``-marked tests hold ``csrc/flash_fwd.cu`` against the plain PyTorch
version (``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``;
the repo's ``conftest.py`` imports JAX). Tolerances on the card: the kernel
and the plain version both compute in fp32 from the same inputs, so the fp32
O and the LSE of either dtype agree to 1e-4 (summation order only); a bf16 O
is that result rounded once, so it may differ by one bf16 ulp of an element,
at most 2^-7 of the largest |O|.
"""

import numpy as np
import pytest
import torch

from ldm3d_torch.ops import attention as tattn


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 for _ in range(3))


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v = _qkv((1, 20, 2, 16), seed=3)
    before = tattn.flash_attention_fwd.launches
    out = tattn.volumetric_attention(q, k, v)
    ref, _ = tattn.attention_reference(q, k, v)
    assert torch.equal(out, ref)
    assert tattn.flash_attention_fwd.launches == before


def test_bf16_plain_is_fp32_math_cast_once():
    q, k, v = (t.to(torch.bfloat16) for t in _qkv((1, 30, 2, 16), seed=4))
    out, lse = tattn.attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = tattn.attention_reference(q.float(), k.float(), v.float())
    assert torch.equal(out, ref.to(torch.bfloat16))


@pytest.mark.parametrize("bad", ["rank", "kv_heads", "dtype", "empty"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = _qkv((1, 8, 2, 16), seed=5)
    if bad == "rank":
        q = q[0]
    elif bad == "kv_heads":
        k, v = k[:, :, :1], v[:, :, :1]
    elif bad == "dtype":
        k = k.double()
    else:
        q = q[:, :0]
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, k, v)


def test_non_cpu_non_cuda_device_raises():
    """Only CPU tensors reach the plain version: any other device that is not
    CUDA raises instead of silently computing somewhere else."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tattn.flash_attention_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version on the card, on strided
    views of a fused qkv as the attention block gives them (ragged n, d 40)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    b, n, h, d = 2, 125, 3, 40
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dt)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
    out, lse = tattn.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = tattn.attention_reference(q, k, v)
    ref_max = ref.float().abs().max().item()
    tol = 1e-4 if dt == torch.float32 else 2.0**-7 * ref_max
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_counts_launches_and_rejects_what_it_cannot_take():
    """On a CUDA tensor the kernel runs (and is counted) or the call raises:
    a head_dim that is not a multiple of 8 never reaches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q = torch.randn((1, 16, 2, 16), device="cuda")
    before = tattn.flash_attention_fwd.launches
    tattn.volumetric_attention(q, q, q)
    assert tattn.flash_attention_fwd.launches == before + 1
    bad = torch.randn((1, 16, 2, 12), device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        tattn.volumetric_attention(bad, bad, bad)
    assert tattn.flash_attention_fwd.launches == before + 1

