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



# --- flash-attention backward (csrc/flash_bwd.cu) and GroupNorm sums
# (csrc/groupnorm_sums.cu). Tolerances on the card: the kernels and their
# plain versions compute in fp32 from the same inputs and differ by summation
# order only. Attention gradients: fp32 within 1e-4 of the largest |grad| of
# each output; bf16 within one bf16 ulp of it (2^-7 of the largest |grad|),
# as each is the fp32 result rounded once. GroupNorm sums: within 1e-5 of the
# sum of the absolute terms of each (batch, channel) (sum |x| for the plain
# sums, sum x^2 or |dy * x_hat| for the others), from fp32 sums of up to
# 10^5 terms in different orders.

from ldm3d_torch.ops import groupnorm as tgn  # noqa: E402


def grad_tol(dtype, ref_max: float) -> float:
    return (1e-4 if dtype == torch.float32 else 2.0**-7) * ref_max


def test_cpu_backward_wrappers_run_plain_and_count_no_launch():
    q, k, v = (t.requires_grad_() for t in _qkv((1, 20, 2, 16), seed=6))
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    tattn.volumetric_attention(q, k, v).square().sum().backward()
    out, lse = tattn.attention_reference(q.detach(), k.detach(), v.detach())
    ref = tattn.attention_bwd_reference(q.detach(), k.detach(), v.detach(), out, lse,
                                        2.0 * out)
    for got, want in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(got, want)
    assert (tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == before


@pytest.mark.parametrize("b,h", [(1, 3), (2, 1), (2, 3)])
def test_bwd_rowsum_is_contiguous_batch_major(b, h):
    """D = rowsum(dO * O) comes out (batch*heads, tokens) and contiguous at
    every batch and head count, as the kernels read it."""
    do, o = (torch.randn(b, 7, h, 8) for _ in range(2))
    dvec = tattn.attention_bwd_dvec(do, o)
    assert dvec.is_contiguous() and dvec.shape == (b * h, 7)
    assert torch.allclose(dvec.reshape(b, h, 7), (do * o).sum(-1).transpose(1, 2))


def test_cpu_gn_wrappers_run_plain_and_count_no_launch():
    x = torch.randn(2, 8, 3, 4, 5).contiguous(memory_format=torch.channels_last_3d)
    before = (tgn.gn_sums.launches, tgn.gn_bwd_sums.launches)
    s1, s2 = tgn.gn_sums(x)
    assert torch.equal(s1, x.sum(dim=(2, 3, 4))) and torch.equal(s2, (x * x).sum(dim=(2, 3, 4)))
    mean, inv = torch.randn(2, 8), torch.rand(2, 8) + 0.5
    b1, _ = tgn.gn_bwd_sums(x, x, mean, inv)
    assert torch.equal(b1, s1)
    assert (tgn.gn_sums.launches, tgn.gn_bwd_sums.launches) == before


def test_gn_wrappers_reject_bad_inputs():
    x = torch.randn(2, 8, 3, 4, 5)
    with pytest.raises(ValueError):
        tgn.gn_sums(x[:, :, 0, 0, 0])          # no spatial dim
    with pytest.raises(ValueError):
        tgn.gn_bwd_sums(x.double(), x, torch.zeros(2, 8), torch.ones(2, 8))
    with pytest.raises(ValueError):
        tgn.gn_bwd_sums(x, x, torch.zeros(2, 4), torch.ones(2, 8))
    with pytest.raises(ValueError, match="cuda"):
        tgn.gn_sums(torch.empty((2, 8, 3, 4, 5), device="meta"))


def test_gn_strides_take_both_layouts_and_raise_on_others():
    x = torch.randn(2, 8, 3, 4, 5)
    assert tgn._bvc_strides(x, "x") == (480, 1, 60)
    cl = x.contiguous(memory_format=torch.channels_last_3d)
    assert tgn._bvc_strides(cl, "x") == (480, 8, 1)
    with pytest.raises(ValueError, match="flatten"):
        tgn._bvc_strides(x.transpose(3, 4), "x")


def test_gn_kernel_x_must_be_channels_minor():
    """The kernels read x channels minor only (dy in either layout above)."""
    x = torch.randn(2, 8, 3, 4, 5)
    assert tgn._x_strides(x.contiguous(memory_format=torch.channels_last_3d)) == (480, 8, 1)
    assert tgn._x_strides(x[:, :1]) == (480, 1, 1)     # one channel: its stride is unused
    with pytest.raises(ValueError, match="unit channel stride"):
        tgn._x_strides(x)


def _attn_case(shape, dtype, seed):
    """q, k, v as strided views of a fused qkv, dO, and the kernel forward's O, LSE."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
    do = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
    out, lse = tattn.flash_attention_fwd(q, k, v)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 100, 3, 40), (2, 125, 4, 64), (1, 300, 1, 256)])
def test_flash_bwd_kernels_match_plain_on_card(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v, out, lse, do = _attn_case(shape, dt, seed=shape[1])
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    grads = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    refs = tattn.attention_bwd_reference(q, k, v, out, lse, do)
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dt and got.shape == want.shape
        ref_max = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= grad_tol(dt, ref_max), (name, err, ref_max)


def _sum_tol(terms: torch.Tensor) -> torch.Tensor:
    return 1e-5 * terms.double().abs().sum(dim=(2, 3, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last_3d", "contiguous"])
@pytest.mark.parametrize("shape", [(2, 64, 20, 20, 20), (3, 96, 5, 5, 5), (1, 32, 33, 17, 9)])
def test_gn_sums_kernels_match_plain_on_card(dtype, layout, shape):
    """x channels_last_3d, as the activations are; dy in ``layout``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    fmt = {"channels_last_3d": torch.channels_last_3d, "contiguous": torch.contiguous_format}[layout]
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dt).contiguous(
        memory_format=torch.channels_last_3d)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt).contiguous(memory_format=fmt)
    mean = torch.randn(shape[:2], generator=gen, device="cuda")
    inv = torch.rand(shape[:2], generator=gen, device="cuda") + 0.5
    before = (tgn.gn_sums.launches, tgn.gn_bwd_sums.launches)
    got = tgn.gn_sums(x) + tgn.gn_bwd_sums(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert (tgn.gn_sums.launches, tgn.gn_bwd_sums.launches) == (before[0] + 1, before[1] + 1)
    want = tgn.gn_sums_reference(x) + tgn.gn_bwd_sums_reference(dy, x, mean, inv)
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean[..., None, None, None]) * inv[..., None, None, None]
    tols = (_sum_tol(xf), _sum_tol(xf * xf), _sum_tol(dyf), _sum_tol(dyf * xhat))
    for i, (g, w, tol) in enumerate(zip(got, want, tols)):
        assert ((g.double() - w.double()).abs() <= tol).all(), (i, (g - w).abs().max().item())


@pytest.mark.cuda
def test_gn_sums_kernels_raise_on_ncdhw_x_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.randn((2, 64, 4, 4, 4), device="cuda")
    before = (tgn.gn_sums.launches, tgn.gn_bwd_sums.launches)
    with pytest.raises(ValueError, match="unit channel stride"):
        tgn.gn_sums(x)
    with pytest.raises(ValueError, match="unit channel stride"):
        tgn.gn_bwd_sums(x, x, torch.zeros((2, 64), device="cuda"), torch.ones((2, 64), device="cuda"))
    assert (tgn.gn_sums.launches, tgn.gn_bwd_sums.launches) == before


@pytest.mark.cuda
def test_groupnorm_module_backward_on_card_matches_cpu():
    """GroupNorm32's forward and closed-form backward through both kernels on
    the card against the same module on the CPU (plain sums), fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ldm3d_torch.nn.blocks import GroupNorm32

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 64, 6, 7, 8), generator=gen).contiguous(memory_format=torch.channels_last_3d)
    dy = torch.randn((2, 64, 6, 7, 8), generator=gen)
    results = {}
    for device in ("cuda", "cpu"):
        gn = GroupNorm32(64, 32).to(device)
        with torch.no_grad():
            gn.weight.copy_(torch.linspace(0.5, 1.5, 64))
            gn.bias.copy_(torch.linspace(-1.0, 1.0, 64))
        xd = x.to(device).requires_grad_()
        y = gn(xd)
        y.backward(dy.to(device))
        results[device] = [t.detach().cpu() for t in (y, xd.grad, gn.weight.grad, gn.bias.grad)]
    for got, want in zip(results["cuda"], results["cpu"]):
        assert (got - want).abs().max().item() <= 1e-4
