"""The attention wrapper's rules and the CUDA kernel against its plain version.

No JAX here: this file also runs on the machine with the card, where the
``cuda``-marked tests hold ``csrc/flash_fwd.cu`` against the plain PyTorch
version (``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``;
the repo's ``conftest.py`` imports JAX). Tolerances on the card: the kernel
and the plain version both compute in fp32 from the same inputs, so the fp32
O and the LSE of either dtype agree to 1e-4 (summation order; the fp32
tensor-core kernel's 3xTF32 split carries each product to about 2^-20 of
itself); a bf16 O may differ by one bf16 ulp of an element, at most 2^-7 of
the largest |O|: the plain version rounds its fp32 result once, and the bf16
tensor-core kernel also rounds P to bf16 before P·V (about 2^-9 of |O|; both
kernels' roundings are emulated on the CPU in
``tests/test_torch_attention.py``).
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


def _attn_views(b, n, h, d, kv_len, dtype, gen):
    """q, k, v as strided views of fused projections, as the attention block
    gives them: one (b, n, 3hd) qkv, or with kv_len a (b, n, hd) q beside a
    fused (b, kv_len, 2hd) kv."""
    if kv_len is None:
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
        return tuple(t.unflatten(-1, (h, d)) for t in qkv.chunk(3, dim=-1))
    q = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype).unflatten(-1, (h, d))
    kv = torch.randn((b, kv_len, 2 * h * d), generator=gen, device="cuda").to(dtype)
    return (q, *(t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1)))


# (b, n, h, d, kv_len or None for a fused qkv): every bf16 instantiation
# (d <= 64, <= 128, <= 256), d not a multiple of 16, token counts that are
# not multiples of the 128-row query tile or the 64-key kv tile, and
# batch x heads > 1
CARD_CASES = [
    (2, 125, 3, 40, None),
    (2, 63, 3, 8, None),
    (1, 1, 2, 64, None),
    (3, 129, 2, 72, None),
    (2, 65, 2, 136, None),
    (1, 63, 1, 256, 65),
    (1, 1, 1, 256, 8000),
    (2, 100, 4, 64, 37),
    (2, 8000, 1, 256, None),
    (1, 1000, 8, 64, None),
]


@pytest.mark.parametrize("case", ["aligned", "offset", "pitch", "size_one_dim"])
def test_16_byte_rows_check_names_the_tensor(case):
    """The bf16 kernel's copy rule, checked on CPU tensors (the check reads
    only pointers and strides): a fused-qkv view with d a multiple of 8
    passes; a view 2 bytes off, or with a token stride of 776 bytes, raises
    naming the tensor; the stride of a dim of size one is never used."""
    h, d = 2, 64
    if case == "offset":
        base = torch.zeros((1, 5, 3 * h * d + 1), dtype=torch.bfloat16)[..., 1:]
    elif case == "pitch":
        base = torch.zeros((2, 5, 3 * h * d + 4), dtype=torch.bfloat16)[..., :3 * h * d]
    else:
        base = torch.zeros((2, 5, 3 * h * d), dtype=torch.bfloat16)
    k = base.chunk(3, dim=-1)[1].unflatten(-1, (h, d))
    if case == "size_one_dim":
        k = torch.as_strided(k, (1, 5, h, d), (7, 3 * h * d, d, 1), k.storage_offset())
    if case in ("offset", "pitch"):
        with pytest.raises(ValueError, match="^k must"):
            tattn.check_16_byte_rows("k", k)
    else:
        tattn.check_16_byte_rows("k", k)


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    """A source's library is named by a hash of the source and of every
    ``csrc/*.cuh``: an edited header gives a new library, never a stale one."""
    from ldm3d_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "blocks.cuh"\n')
    (tmp_path / "blocks.cuh").write_text("// v1\n")
    first = _kernels._library_path("k.cu")
    assert first == _kernels._library_path("k.cu")
    assert first.name.startswith("libk-") and first.parent == _kernels.BUILD_DIR
    (tmp_path / "blocks.cuh").write_text("// v2\n")
    second = _kernels._library_path("k.cu")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _kernels._library_path("k.cu") not in (first, second)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_fwd_bf16_mma_kernelILi256ELi32EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiillllllllllf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125flash_fwd_bf16_mma_kernelILi256ELi32EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiillllllllllf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_fwd_fp32_kernelILi64EEEvPKfS2_S2_PfS3_iiiillllllllllf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_fwd_fp32_kernelILi64EEEvPKfS2_S2_PfS3_iiiillllllllllf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 2048 bytes smem, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiiiilllllllllllf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiiiilllllllllllf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi64EEEvPKT_S2_S2_S2_PKfS4_PS0_S5_iiiiilllllllllllf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelIfLi64EEEvPKT_S2_S2_S2_PKfS4_PS0_S5_iiiiilllllllllllf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_131flash_bwd_dkv_tf32x3_mma_kernelILi256EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiiNS_7StridesEffi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_131flash_bwd_dkv_tf32x3_mma_kernelILi256EEEvPKfS2_S2_S2_S2_S2_PfS3_iiiiiNS_7StridesEffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 210 registers, used 1 barriers, 488 bytes cmem[0]
ptxas info    : Compiling entry function 'ldm3d_plain_c' for 'sm_90a'
ptxas info    : Function properties for ldm3d_plain_c
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_names_each_instantiation():
    from ldm3d_torch.ops._kernels import ptxas_report

    report = ptxas_report(PTXAS_LOG)
    assert report == {
        "flash_fwd_bf16_mma_kernel<256, 32>": {"registers": 255, "smem_bytes": 0,
                                               "stack_bytes": 0, "spill_stores": 8,
                                               "spill_loads": 4},
        "flash_fwd_fp32_kernel<64>": {"registers": 80, "smem_bytes": 2048, "stack_bytes": 0,
                                      "spill_stores": 0, "spill_loads": 0},
        "flash_bwd_dkv_kernel<__nv_bfloat16, 64>": {"registers": 125, "smem_bytes": 0,
                                                    "stack_bytes": 0, "spill_stores": 0,
                                                    "spill_loads": 0},
        "flash_bwd_dkv_kernel<float, 64>": {"registers": 127, "smem_bytes": 0, "stack_bytes": 0,
                                            "spill_stores": 0, "spill_loads": 0},
        "flash_bwd_dkv_tf32x3_mma_kernel<256>": {"registers": 210, "smem_bytes": 0,
                                                 "stack_bytes": 0, "spill_stores": 0,
                                                 "spill_loads": 0},
        "ldm3d_plain_c": {"registers": 32, "smem_bytes": 0, "stack_bytes": 0,
                          "spill_stores": 0, "spill_loads": 0},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c[:4])) + (
    "" if c[4] is None else f"-kv{c[4]}"))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype, case):
    """The CUDA kernel of each dtype's route against its plain version on the
    card, on strided views of fused projections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    b, n, h, d, kv_len = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case[:4]))
    q, k, v = _attn_views(b, n, h, d, kv_len, dt, gen)
    before = tattn.flash_attention_fwd.launches
    out, lse = tattn.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_fwd.launches == before + 1
    assert out.shape == (b, n, h, d) and out.dtype == dt and lse.shape == (b * h, n)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    ref_max = ref.float().abs().max().item()
    tol = 1e-4 if dt == torch.float32 else 2.0**-7 * ref_max
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_bf16_kernel_raises_on_misaligned_views_and_fp32_takes_them():
    """The bf16 route copies rows in 16-byte pieces: a view that starts off
    16 bytes, or whose token stride is not whole 16 bytes, raises naming the
    tensor, without a launch and without a copy. The fp32 route reads element
    by element and takes the same views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    b, n, h, d = 1, 70, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        off = torch.randn((b, n, 3 * h * d + 1), generator=gen, device="cuda").to(dtype)[..., 1:]
        pitch = torch.randn((b, n, 3 * h * d + 4), generator=gen, device="cuda").to(dtype)
        for base in (off, pitch[..., :3 * h * d]):
            q, k, v = (t.unflatten(-1, (h, d)) for t in base.chunk(3, dim=-1))
            before = tattn.flash_attention_fwd.launches
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match="^q must"):
                    tattn.flash_attention_fwd(q, k, v)
                assert tattn.flash_attention_fwd.launches == before
            else:
                out, lse = tattn.flash_attention_fwd(q, k, v)
                torch.cuda.synchronize()
                ref, ref_lse = tattn.attention_reference(q, k, v)
                assert (out - ref).abs().max().item() <= 1e-4
                assert (lse - ref_lse).abs().max().item() <= 1e-4
                assert tattn.flash_attention_fwd.launches == before + 1


def _kernel_names(fn, part: str, launches: int) -> dict:
    """The device kernels whose names hold ``part`` that one call of ``fn``
    launches (after a warm-up call), with their launch counts, from the
    profiler's trace. ``launches``: how many such kernels the call makes. A
    trace that holds fewer or more is taken again, up to three times: the
    profiler now and then hands back a session that lost some or all of its
    device events (seen on the card with torch 2.11)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {ev.key: ev.count for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA and part in ev.key
                 and not ev.key.startswith(("Memcpy", "Memset"))}
        if sum(names.values()) == launches:
            break
    return names


@pytest.mark.cuda
def test_kernel_routes_by_dtype_on_card():
    """bf16 runs the bf16 tensor-core kernel and fp32 the 3xTF32 tensor-core
    kernel, by the kernels' names in the profiler's trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _attn_views(1, 200, 2, 64, None, dtype, gen)
        names[dtype] = set(_kernel_names(lambda: tattn.flash_attention_fwd(q, k, v), "flash_fwd",
                                         1))
    assert any("flash_fwd_bf16_mma_kernel" in name for name in names[torch.bfloat16])
    assert not any("tf32" in name for name in names[torch.bfloat16])
    assert any("flash_fwd_tf32x3_mma_kernel" in name for name in names[torch.float32])
    assert not any("bf16" in name for name in names[torch.float32])


@pytest.mark.cuda
def test_kernel_counts_launches_and_rejects_what_it_cannot_take():
    """On a CUDA tensor the kernel runs (and is counted) or the call raises:
    a head_dim that is not a multiple of 8 runs zero-padded (one launch, held
    to the plain version), and a dtype the kernels do not take raises without
    a launch; neither reaches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((1, 16, 2, 16), device="cuda", generator=gen)
    before = tattn.flash_attention_fwd.launches
    tattn.volumetric_attention(q, q, q)
    assert tattn.flash_attention_fwd.launches == before + 1
    odd = torch.randn((1, 16, 2, 12), device="cuda", generator=gen)
    for fn in (tattn.volumetric_attention, lambda *a: tattn.flash_attention_fwd(*a)[0]):
        out = fn(odd, odd, odd)
        assert out.shape == odd.shape
        assert (out - tattn.attention_reference(odd, odd, odd)[0]).abs().max().item() <= 1e-4
    assert tattn.flash_attention_fwd.launches == before + 3
    half = q.half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.flash_attention_fwd(half, half, half)
    assert tattn.flash_attention_fwd.launches == before + 3


# the shapes of chip_smoke.py's kernel phase: the flagship's attention at 80^3
# and 96^3, batch 1 and 2, a ragged odd case, the training shapes, and the
# edge shapes (every head-width instantiation, ragged token counts, kv != n)
SMOKE_FWD_SHAPES = [
    (1, 1000, 8, 64), (1, 125, 16, 64), (1, 8000, 1, 256), (1, 1728, 8, 64), (1, 216, 16, 64),
    (1, 13824, 1, 256), (2, 1000, 8, 64), (2, 125, 16, 64), (2, 8000, 1, 256), (2, 100, 3, 40),
    (2, 63, 3, 8), (1, 1, 2, 64), (3, 129, 2, 72), (2, 65, 2, 136), (1, 63, 1, 256, 65),
    (1, 1, 1, 256, 8000), (2, 100, 4, 64, 37), (20, 1000, 8, 64), (20, 125, 16, 64),
    (20, 8000, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMOKE_FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fp32_forward_runs_tf32x3_and_matches_plain_on_card(shape):
    """The fp32 forward at every shape of chip_smoke.py's kernel phase: O and
    LSE within 1e-4 of the plain version, through flash_fwd_tf32x3_mma_kernel
    (one launch of it, by name in the profiler's trace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, h, d = shape[:4]
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = _attn_views(b, n, h, d, shape[4] if len(shape) > 4 else None, torch.float32, gen)
    names = _kernel_names(lambda: tattn.flash_attention_fwd(q, k, v), "flash_fwd", 1)
    assert len(names) == 1 and "flash_fwd_tf32x3_mma_kernel" in next(iter(names))
    assert next(iter(names.values())) == 1
    out, lse = tattn.flash_attention_fwd(q, k, v)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    assert (out - ref).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4


# (b, n, h, d): head widths not a multiple of 8 (padded), above 256 (the wide
# route: 320 and 512, both past one 128-dim block of O), and batch * heads
# past 65,535
C2_CASES = [(2, 70, 3, 36), (1, 150, 2, 320), (2, 70, 1, 512), (35000, 8, 2, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", C2_CASES, ids=lambda s: "x".join(map(str, s)))
def test_attention_takes_any_head_width_and_head_count_on_card(dtype, shape):
    """volumetric_attention forward and backward (through autograd) on the
    card against the plain versions, at the limits of the kernels' own
    tests: O within 1e-4 (fp32) or 2^-7 max|O| (bf16), each gradient within
    1e-4 or 2^-7 of its largest |value|; one forward, one dQ and one dK/dV
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (t.detach().requires_grad_() for t in _attn_views(b, n, h, d, None, dt, gen))
    do = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dt)
    before = (tattn.flash_attention_fwd.launches, tattn.flash_attention_bwd_dq.launches,
              tattn.flash_attention_bwd_dkv.launches)
    out = tattn.volumetric_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_fwd.launches, tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == tuple(x + 1 for x in before)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref, lse = tattn.attention_reference(qd, kd, vd)
    assert out.shape == ref.shape and out.dtype == dt
    ref_max = ref.float().abs().max().item()
    tol = 1e-4 if dt == torch.float32 else 2.0**-7 * ref_max
    assert (out.float() - ref.float()).abs().max().item() <= tol
    refs = tattn.attention_bwd_reference(qd, kd, vd, ref, lse, do)
    for got, want in zip(grads, refs):
        assert got.shape == want.shape and got.dtype == dt
        err = (got.float() - want.float()).abs().max().item()
        assert err <= grad_tol(dt, want.float().abs().max().item())


@pytest.mark.cuda
def test_wide_head_route_by_name_on_card():
    """d > 256 runs the wide kernels in both dtypes (forward, dQ, dK/dV)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.detach().requires_grad_()
                   for t in _attn_views(1, 40, 1, 512, None, dtype, gen))
        names = _kernel_names(
            lambda: tattn.volumetric_attention(q, k, v).float().square().sum().backward(),
            "flash_", 3)
        for kernel in ("flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
                       "flash_bwd_dkv_wide_kernel"):
            assert sum(n for name, n in names.items() if kernel in name) == 1, names



# --- flash-attention backward (csrc/flash_bwd.cu) and GroupNorm sums
# (csrc/groupnorm_sums.cu). Tolerances on the card: the kernels and their
# plain versions compute in fp32 from the same inputs and differ by summation
# order only, except that the bf16 tensor-core backward splits P and dS into
# two bf16 parts (hi and the rounded remainder) before its products.
# Attention gradients: fp32 within 1e-4 of the largest |grad| of each output;
# bf16 within one bf16 ulp of it (2^-7 of the largest |grad|), as each is the
# fp32 result rounded once (the split's own error is emulated on the CPU in
# ``tests/test_torch_attention_grad.py``). GroupNorm sums: within 1e-5 of the
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


@pytest.mark.parametrize("name", ["q", "k", "v", "dO"])
def test_bwd_kernel_args_check_16_byte_rows_in_bf16(name):
    """The backward kernels' checks, on CPU tensors (they read only shapes,
    pointers and strides): in bf16 a q, k, v or dO view 2 bytes off 16
    raises naming that tensor; the same views in fp32 pass, as the scalar
    route reads element by element."""
    b, n, h, d = 1, 6, 2, 16
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.zeros((b, n, 3 * h * d), dtype=dtype)
        t = dict(zip(("q", "k", "v"), (x.unflatten(-1, (h, d)) for x in qkv.chunk(3, dim=-1))))
        t["dO"] = torch.zeros((b, n, h, d), dtype=dtype)
        t[name] = torch.zeros((b, n, h * d + 1), dtype=dtype)[..., 1:].unflatten(-1, (h, d))
        lse, dvec = torch.zeros((b * h, n)), torch.zeros((b * h, n))
        args = (t["q"], t["k"], t["v"], t["dO"], lse, dvec)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match=f"^{name} must start on a 16-byte boundary"):
                tattn._bwd_kernel_args(*args)
        else:
            assert len(tattn._bwd_kernel_args(*args)) == 12


def _attn_case(shape, dtype, seed):
    """q, k, v as strided views of fused projections (a fused qkv, or for a
    (b, n, h, d, kv_len) shape a q beside a fused kv), dO, and the kernel
    forward's O, LSE."""
    b, n, h, d = shape[:4]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _attn_views(b, n, h, d, shape[4] if len(shape) > 4 else None, dtype, gen)
    do = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
    out, lse = tattn.flash_attention_fwd(q, k, v)
    return q, k, v, out, lse, do


# (b, n, h, d[, kv_len]): every instantiation (DMAX 64, 128, 256; d = 8, 40,
# 72, 136 not multiples of 16; d = 136 and 256 take dK/dV's head-dim split),
# token counts off the 128-row and 64-, 32-key tiles, n = 1 (beside 37 or
# 8000 keys: with one key dQ and dK are 0 and a relative limit means
# nothing), kv_len != n, and the two UNet training shapes at batch 2
BWD_CARD_CASES = [(2, 100, 3, 40), (2, 125, 4, 64), (1, 300, 1, 256), (2, 63, 3, 8),
                  (1, 1, 2, 64, 37), (3, 129, 2, 72), (2, 65, 2, 136), (1, 63, 1, 256, 65),
                  (1, 1, 1, 256, 8000), (2, 100, 4, 64, 37), (2, 1000, 8, 64), (2, 125, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_CARD_CASES)
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


# chip_smoke.py's fp32 backward cases: the UNet's training shapes, a ragged
# d = 40, the VAE's d = 256 at 80^3, and the edge cases above (d = 8, 64, 72,
# 136, 256: every instantiation of the 3xTF32 kernels; ragged n, n = 1,
# kv_len != n)
SMOKE_BWD_SHAPES = [(20, 1000, 8, 64), (20, 125, 16, 64), (2, 100, 3, 40), (1, 8000, 1, 256),
                    (2, 63, 3, 8), (1, 1, 2, 64, 37), (3, 129, 2, 72), (2, 65, 2, 136),
                    (1, 63, 1, 256, 65), (1, 1, 1, 256, 8000), (2, 100, 4, 64, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SMOKE_BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fp32_backward_runs_tf32x3_matches_plain_and_repeats_bits_on_card(shape):
    """The 3xTF32 dQ and dK/dV kernels: one launch each, every gradient
    within 1e-4 of its largest |grad| of the plain version, and the same bits
    on a second run (nothing is summed across blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, out, lse, do = _attn_case(shape, torch.float32, seed=sum(shape))
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    grads = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    again = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == (before[0] + 2, before[1] + 2)
    refs = tattn.attention_bwd_reference(q, k, v, out, lse, do)
    for name, got, repeat, want in zip(("dq", "dk", "dv"), grads, again, refs):
        assert torch.equal(got, repeat), name
        err = (got - want).abs().max().item()
        assert err <= grad_tol(torch.float32, want.abs().max().item()), (name, err)


@pytest.mark.cuda
def test_flash_bwd_raises_on_misaligned_bf16_views_and_fp32_takes_them():
    """The bf16 backward copies rows in 16-byte pieces: a q, k, v or dO view
    that starts 2 bytes off 16 raises naming it, without a launch and
    without a copy; the fp32 route takes the same views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, h, d = 1, 70, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("q", "k", "v", "dO"):
            t = dict(zip(("q", "k", "v"), _attn_views(b, n, h, d, None, dtype, gen)))
            t["dO"] = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
            off = torch.randn((b, n, h * d + 1), generator=gen, device="cuda").to(dtype)
            t[name] = off[..., 1:].unflatten(-1, (h, d))
            q, k, v, do = t["q"], t["k"], t["v"], t["dO"]
            out, lse = tattn.attention_reference(q, k, v)
            dvec = tattn.attention_bwd_dvec(do, out)
            before = (tattn.flash_attention_bwd_dq.launches,
                      tattn.flash_attention_bwd_dkv.launches)
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match=f"^{name} must"):
                    tattn.flash_attention_bwd_dq(q, k, v, do, lse, dvec)
                with pytest.raises(ValueError, match=f"^{name} must"):
                    tattn.flash_attention_bwd_dkv(q, k, v, do, lse, dvec)
                assert (tattn.flash_attention_bwd_dq.launches,
                        tattn.flash_attention_bwd_dkv.launches) == before
                continue
            grads = (tattn.flash_attention_bwd_dq(q, k, v, do, lse, dvec),
                     *tattn.flash_attention_bwd_dkv(q, k, v, do, lse, dvec))
            torch.cuda.synchronize()
            refs = tattn.attention_bwd_reference(q, k, v, out, lse, do)
            for got, want in zip(grads, refs):
                assert (got - want).abs().max().item() <= grad_tol(dtype, want.abs().max().item())
            assert (tattn.flash_attention_bwd_dq.launches,
                    tattn.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_flash_bwd_routes_by_dtype_and_counts_exact_launches_on_card():
    """One backward through autograd launches exactly one dQ and one dK/dV
    kernel: the bf16 tensor-core kernels in bf16 and the 3xTF32 tensor-core
    kernels in fp32 (no scalar kernel), by the kernels' names in the
    profiler's trace. A head_dim that is not a multiple of 8 runs
    zero-padded, one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.detach().requires_grad_() for t in _attn_views(1, 200, 2, 64, None, dtype,
                                                                    gen))

        def step():
            tattn.volumetric_attention(q, k, v).float().square().sum().backward()

        step()
        torch.cuda.synchronize()
        before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
        step()
        torch.cuda.synchronize()
        assert (tattn.flash_attention_bwd_dq.launches,
                tattn.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
        names[dtype] = _kernel_names(step, "flash_bwd", 2)
        assert all(n == 1 for n in names[dtype].values()), names[dtype]
    for kind in ("dq", "dkv"):
        assert any(f"flash_bwd_{kind}_bf16_mma_kernel" in x for x in names[torch.bfloat16])
        assert any(f"flash_bwd_{kind}_tf32x3_mma_kernel" in x for x in names[torch.float32])
    assert not any("tf32" in x for x in names[torch.bfloat16])
    assert not any("bf16" in x or "fp32_kernel" in x for x in names[torch.float32])
    odd = torch.randn((1, 16, 2, 12), device="cuda", dtype=torch.bfloat16)
    before = (tattn.flash_attention_bwd_dq.launches, tattn.flash_attention_bwd_dkv.launches)
    out, lse = tattn.attention_reference(odd, odd, odd)
    dvec = tattn.attention_bwd_dvec(odd, out)
    dq = tattn.flash_attention_bwd_dq(odd, odd, odd, odd, lse, dvec)
    dk, dv = tattn.flash_attention_bwd_dkv(odd, odd, odd, odd, lse, dvec)
    assert dq.shape == dk.shape == dv.shape == odd.shape
    assert (tattn.flash_attention_bwd_dq.launches,
            tattn.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)


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


# the GroupNorm inputs of the flagship's paths (config_train_32g.json at 80^3):
# the VAE's levels, the UNet's levels and skip concatenations at batch 1
# (sampling), 2 (serving) and 20 (training), in bf16 and fp32
GN_CARD_SHAPES = [(1, 64, 80, 80, 80), (1, 128, 40, 40, 40), (1, 256, 20, 20, 20),
                  (1, 512, 10, 10, 10), (1, 1024, 5, 5, 5), (1, 1536, 10, 10, 10),
                  (2, 768, 20, 20, 20), (2, 1024, 5, 5, 5), (20, 64, 80, 80, 80),
                  (20, 256, 20, 20, 20), (3, 40, 7, 9, 11)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GN_CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_sums_one_launch_deterministic_and_matches_plain_on_card(dtype, shape):
    """B4 at the flagship's GroupNorm inputs: within 1e-5 of the absolute
    sums of its plain version, the same bits on two runs, and one kernel
    launch a call (by the profiler's count), the wrapper counting one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + 0.3).to(dt).contiguous(
        memory_format=torch.channels_last_3d)
    before = tgn.gn_sums.launches
    got = tgn.gn_sums(x)
    again = tgn.gn_sums(x)
    torch.cuda.synchronize()
    assert tgn.gn_sums.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xf = x.float()
    for g, w, terms in zip(got, tgn.gn_sums_reference(x), (xf, xf * xf)):
        assert ((g.double() - w.double()).abs() <= _sum_tol(terms)).all()
    names = _kernel_names(lambda: tgn.gn_sums(x), "", 1)
    assert len(names) == 1 and "gn_sums_onepass" in next(iter(names)), names
    assert next(iter(names.values())) == 1
