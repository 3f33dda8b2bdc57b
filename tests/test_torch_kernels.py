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

import math

import numpy as np
import pytest
import torch

from ldm3d_torch.ops import attention as tattn

torch.set_num_threads(1)


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


# two kernel nodes of a cudaGraphDebugDotPrint dump taken on the H100 (torch
# 2.11, CUDA 12.8), a kernel with an unmangled name and a memset node
_DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 3) | _ZN50_GLOBAL__N__ce131c08_17_groupnorm_sums_cu_d127756815gn_sums_onepassIfLi4ELb1EEEvPKT_llPfS4_Pjiiii\<\<\<\{2,4\},256,0\>\>\>}
| {{node handle | func handle} | {0x000000000B73EA00 | 0x000000000A6283F0}}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 2) | _ZN45_GLOBAL__N__2ad35770_12_flash_fwd_cu_89a37f9025flash_fwd_bf16_mma_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiilllllllllf\<\<\<2,256,55296\>\>\>}
| {{node handle | func handle} | {0x000000000B73F168 | 0x000000000A808A50}}
}"];

"graph_1_node_2"[style="bold" shape="record" label="{MEMSET
| {ID | 2 (topoId: 1)}
}"];

"graph_1_node_3"[style="bold" shape="record" label="{KERNEL
| {ID | 3 (topoId: 0) | plain_c_kernel\<\<\<1,32,0\>\>\>}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
"""


def test_graph_kernel_names_reads_a_dot_dump():
    """The kernel nodes of a dump, in order, by their demangled names; the
    memset node is no kernel."""
    from ldm3d_torch.ops.graphs import graph_kernel_names

    assert graph_kernel_names(_DOT) == ["gn_sums_onepass<float, 4, 1>",
                                        "flash_fwd_bf16_mma_kernel<64>", "plain_c_kernel"]
    assert graph_kernel_names("digraph dot {\n}\n") == []


def _same_bits(got, want) -> bool:
    """Whether two call results (a tensor, or a tuple or list of them, or
    None) hold the same bits."""
    if isinstance(want, torch.Tensor):
        return torch.equal(got, want)
    if isinstance(want, (tuple, list)):
        return len(got) == len(want) and all(_same_bits(g, w) for g, w in zip(got, want))
    return got is None and want is None


def _kernel_names(fn, part: str, launches: int, calls: int = 5) -> dict:
    """The device kernels whose names hold ``part`` that one call of ``fn``
    launches, with their launch counts a call: the kernel nodes of a CUDA
    graph of ``calls`` calls (captured after an eager warm-up call), by the
    names ``cudaGraphDebugDotPrint`` gives them (``ops.graphs.CountedGraph``).
    ``launches``: how many such kernels one call makes. The graph is then
    replayed once, and each captured call's result must hold the warm-up
    call's bits. Fails unless the graph holds ``launches * calls`` such
    kernels: a graph without kernel nodes never passes.

    These names came from ``torch.profiler`` windows before, which lost
    device kernels now and then (``PERF.md`` section 6, C8); a graph's nodes
    are what the card will run, whatever CUPTI records."""
    from ldm3d_torch.ops.graphs import CountedGraph, graph_kernel_names

    want = fn()
    torch.cuda.synchronize()
    graph = CountedGraph(debug=True)
    outs = graph.capture(lambda: [fn() for _ in range(calls)])
    dot = graph.dot()
    names = graph_kernel_names(dot)
    graph.replay()
    torch.cuda.synchronize()
    assert names, f"the graph of {calls} calls holds no kernel node; its dump:\n{dot[:4000]}"
    assert all(_same_bits(out, want) for out in outs), "a replayed call's result differs"
    matched = {}
    for name in names:
        if part in name:
            matched[name] = matched.get(name, 0) + 1
    if sum(matched.values()) != launches * calls:
        pytest.fail(f"the graph of {calls} calls holds {matched} kernels named *{part}*, not "
                    f"{launches} a call; all its kernel nodes: {names}")
    return {k: n // calls if n % calls == 0 else n / calls for k, n in matched.items()}


@pytest.mark.cuda
def test_kernel_routes_by_dtype_on_card():
    """bf16 runs the bf16 tensor-core kernel and fp32 the 3xTF32 tensor-core
    kernel, by the kernels' names in a CUDA graph of the calls."""
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_checkpointed_groupnorm_attention_block_on_card(dtype):
    """A GroupNorm + attention block (``AttentionBlock3D``, two heads of 32)
    under ``remat_wrapped`` on the card: under ``"full"`` and ``"convs"`` its
    gradients (input and parameters) hold the unremated call's bits, the
    same kernels on the same inputs; and a CUDA graph of the remated call
    holds each forward kernel twice (the call and the backward's rerun) and
    the GroupNorm backward sums once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ldm3d_torch.nn.blocks import AttentionBlock3D, remat_wrapped

    torch.manual_seed(6)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.device("cuda"):
        block = AttentionBlock3D(64, 32, 8)
    x = torch.randn((2, 64, 6, 6, 6), generator=gen, device="cuda").to(dtype)
    x = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    dy = dy.contiguous(memory_format=torch.channels_last_3d)
    inputs = [x, *block.parameters()]

    def call(mode):
        return torch.autograd.grad(remat_wrapped(block, mode)(x), inputs, dy)

    plain = call(False)
    for mode in ("full", "convs"):
        assert _same_bits(call(mode), plain), f"remat {mode} changed a gradient"
    fwd = _kernel_names(lambda: call("full"), "flash_fwd", 2)
    assert all(("bf16" in name) == (dtype == torch.bfloat16) for name in fwd)
    _kernel_names(lambda: call("full"), "gn_sums_onepass", 2)
    _kernel_names(lambda: call("full"), "gn_bwd_sums_onepass", 1)
    _kernel_names(lambda: call(False), "flash_fwd", 1)


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


# --- the bf16 forward at 128 < d <= 256: wgmma on tiles that TMA loads

import chip_smoke  # noqa: E402  (its shape lists; it imports numpy and nothing of the port)

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100
# (b, n, h, d[, kv_len]): every d = 256 shape of chip_smoke.py's kernel phase
# and the cuda tests' cases of the route: d = 136 and 200 (boxes past d not
# loaded, dims past d zero-filled), n = 1, kv_len != n
WGMMA_CASES = sorted({s for s in chip_smoke.SHAPES + chip_smoke.TRAIN_SHAPES
                      + chip_smoke.EDGE_SHAPES if 128 < s[3] <= 256}
                     | {(2, 65, 2, 136), (2, 100, 2, 200), (1, 1, 2, 256), (3, 129, 2, 256, 37),
                        (2, 100, 4, 200, 37), (1, 1, 1, 136, 70)})


def _fused_strides(shape):
    """(sb, sn, sh) of q, k, v as views of a fused (b, n, 3hd) qkv, or for a
    (b, n, h, d, kv_len) shape of a (b, n, hd) q and a fused (b, kv, 2hd) kv."""
    b, n, h, d = shape[:4]
    if len(shape) == 4:
        return [(n * 3 * h * d, 3 * h * d, d)] * 3
    kv = shape[4]
    return [(n * h * d, h * d, d)] + [(kv * 2 * h * d, 2 * h * d, d)] * 2


@pytest.mark.parametrize("shape", WGMMA_CASES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_plan_covers_each_query_row_once_with_legal_tensor_maps(shape):
    """The bf16 route at 128 < d <= 256: its grid (query tiles of 128 rows of
    one (batch, head) side by side) computes every query row of every
    (batch, head) exactly once; its shared memory fits the card; and each of
    the q, k, v tensor maps is one TMA can take in the 128-byte swizzle:
    boxes of at most 128 bytes along the contiguous head dim (a whole number
    of 16 bytes) and at most 256 along any dim, strides of whole 16 bytes
    under 2^40, the kv tiles of 64 keys covering kv_len."""
    b, n, h, d = shape[:4]
    kv_len = shape[4] if len(shape) > 4 else n
    plan = tattn.flash_fwd_plan(torch.bfloat16, b, n, h, d, kv_len, _fused_strides(shape))
    assert plan["route"] == "bf16_wgmma" and plan["threads"] == 256
    assert plan["smem_bytes"] <= SMEM_LIMIT
    tiles = math.ceil(n / 128)
    assert plan["grid"] == (b * h * tiles, 1)
    rows = np.zeros((b * h, n), dtype=np.int64)
    for bx in range(plan["grid"][0]):
        bh, tile = divmod(bx, tiles)
        rows[bh, tile * 128:tile * 128 + 128] += 1
    assert (rows == 1).all()
    maps = plan["tensor_maps"]
    for name, rows_of, box_rows in (("q", n, 128), ("k", kv_len, 64), ("v", kv_len, 64)):
        m = maps[name]
        assert m["dims"] == (d, rows_of, h, b) and m["box"] == (64, box_rows, 1, 1)
        inner = m["box"][0] * m["element_bytes"]
        assert inner <= m["swizzle_bytes"] == 128 and inner % 16 == 0
        assert all(1 <= x <= 256 for x in m["box"])
        assert all(st % 16 == 0 and 0 < st < 2**40 for st in m["strides_bytes"])
        assert all(x < 2**32 for x in m["dims"])
    assert math.ceil(kv_len / 64) * 64 >= kv_len


def _wgmma_acc_pos(warp, lane, i):
    """(row, column) of accumulator register i of an m64nN wgmma in thread
    lane of warp ``warp`` of the warpgroup (PTX ISA, wgmma D fragments)."""
    g, t = divmod(lane, 4)
    j, e = divmod(i, 4)
    return 16 * warp + g + 8 * (e // 2), 8 * j + 2 * t + e % 2


def _wgmma_a_pos(warp, lane, r, half):
    """(row, k) of the bf16 in half ``half`` of A register r of an m64k16
    wgmma with A in registers (PTX ISA, wgmma A fragments)."""
    g, t = divmod(lane, 4)
    return 16 * warp + g + 8 * (r % 2), 2 * t + half + 8 * (r // 2)


def test_wgmma_p_registers_are_the_a_operand_of_p_v():
    """The kernel packs S's accumulators into P's A registers as the mma.sync
    kernel does (no new mapping): k-step kk's register 2 * hf + rr holds
    accumulators 4c + 2rr and 4c + 2rr + 1 of n-tile c = 2kk + hf. Through the
    two fragment layouts every packed value lands at its own (query, key):
    a random P of 64 x 64 rebuilds exactly; and O's store takes register
    4c + 2r + e to row g + 8r, column 8c + 2t + e."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((64, 64))
    rebuilt = np.full((64, 64), np.nan)
    for warp in range(4):
        for lane in range(32):
            regs = [p[_wgmma_acc_pos(warp, lane, i)] for i in range(32)]
            for kk in range(4):
                for hf in range(2):
                    for rr in range(2):
                        c = 2 * kk + hf
                        for half in range(2):
                            row, k = _wgmma_a_pos(warp, lane, 2 * hf + rr, half)
                            rebuilt[row, 16 * kk + k] = regs[4 * c + 2 * rr + half]
            g, t = divmod(lane, 4)
            for c in range(32):
                for r in range(2):
                    for e in range(2):
                        assert _wgmma_acc_pos(warp, lane, 4 * c + 2 * r + e) == (
                            16 * warp + g + 8 * r, 8 * c + 2 * t + e)
    assert np.array_equal(rebuilt, p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_CASES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_route_matches_plain_on_card(shape):
    """The bf16 forward at 128 < d <= 256 on strided views of fused
    projections: O within 2^-7 of the largest |O| and the LSE within 1e-4 of
    the plain version, one launch of flash_fwd_bf16_wgmma_kernel (by name in
    a CUDA graph of the calls, and in the wrapper's count of the route), the same
    bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, h, d = shape[:4]
    gen = torch.Generator(device="cuda").manual_seed(sum(shape[:4]))
    q, k, v = _attn_views(b, n, h, d, shape[4] if len(shape) > 4 else None, torch.bfloat16, gen)
    names = _kernel_names(lambda: tattn.flash_attention_fwd(q, k, v), "flash_fwd", 1)
    assert names == {next(iter(names)): 1} and "flash_fwd_bf16_wgmma_kernel" in next(iter(names))
    before = (tattn.flash_attention_fwd.launches,
              tattn.flash_attention_fwd.route_launches["bf16_wgmma"])
    out, lse = tattn.flash_attention_fwd(q, k, v)
    again, lse_again = tattn.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_fwd.launches,
            tattn.flash_attention_fwd.route_launches["bf16_wgmma"]) == (before[0] + 2,
                                                                         before[1] + 2)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    ref, ref_lse = tattn.attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0**-7 * ref.float().abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 200, 256])
def test_wgmma_forward_feeds_the_bf16_backward_on_card(d):
    """volumetric_attention forward and backward in bf16 through autograd:
    the backward reads the wgmma forward's LSE; each gradient within one
    bf16 ulp of its largest |value| (2^-7 of it) of the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (t.detach().requires_grad_()
               for t in _attn_views(2, 300, 1, d, None, torch.bfloat16, gen))
    do = torch.randn((2, 300, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    out = tattn.volumetric_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref, lse = tattn.attention_reference(qd, kd, vd)
    for got, want in zip(grads, tattn.attention_bwd_reference(qd, kd, vd, ref, lse, do)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= grad_tol(torch.bfloat16, want.float().abs().max().item())


# --- the bf16 backward at d <= 128: wgmma on tiles that TMA loads

# (b, n, h, d[, kv_len]): every d <= 128 shape of chip_smoke.py's kernel_bwd
# phase (the training shapes, ragged d = 40, d = 8, 72, n = 1, kv_len != n)
# and d = 128 beside kv_len != n at d = 96
WGMMA_BWD_CASES = sorted({s for s in chip_smoke.BWD_SHAPES + chip_smoke.BWD_EDGE_SHAPES
                          if s[3] <= 128} | {(2, 100, 2, 128), (1, 300, 3, 96, 70)})


def _bwd_strides(shape):
    """(sb, sn, sh) of q, k, v as views of fused projections (as
    :func:`_fused_strides`) and of a contiguous dO."""
    b, n, h, d = shape[:4]
    return _fused_strides(shape) + [(n * h * d, h * d, d)]


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("shape", WGMMA_BWD_CASES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_bwd_plan_covers_each_output_once_with_legal_tensor_maps(shape, kind):
    """The bf16 backward at d <= 128: dQ's grid (query tiles of 128 rows of
    one (batch, head) side by side) computes every query row of every
    (batch, head) exactly once, and dK/dV's grid every key x head-dim
    column exactly once (key tiles of 128 on grid.x, blocks of 64 head dims
    on grid.y); shared memory fits the
    card; and each of the q, k, v, dO tensor maps is one TMA can take in the
    128-byte swizzle (as the forward's), with boxes of 128 resident rows
    (dQ's q and dO, dK/dV's k and v) or 64 streamed ones."""
    b, n, h, d = shape[:4]
    kv_len = shape[4] if len(shape) > 4 else n
    d8 = -(-d // 8) * 8
    plan = tattn.flash_bwd_plan(kind, torch.bfloat16, b, n, h, d8, kv_len, _bwd_strides(shape))
    assert plan["route"] == "bf16_wgmma" and plan["threads"] == 256
    assert plan["smem_bytes"] <= SMEM_LIMIT
    rows = n if kind == "dq" else kv_len
    dout = d8 if kind == "dq" else 64
    tiles = math.ceil(rows / 128)
    assert plan["grid"][0] == b * h * tiles
    cover = np.zeros((b * h, rows, d8), dtype=np.int64)
    for bx in range(plan["grid"][0]):
        bh, tile = divmod(bx, tiles)
        for by in range(plan["grid"][1]):
            cover[bh, tile * 128:tile * 128 + 128, by * dout:by * dout + dout] += 1
    assert (cover == 1).all()
    maps = plan["tensor_maps"]
    res, streamed = (("q", "dO"), ("k", "v")) if kind == "dq" else (("k", "v"), ("q", "dO"))
    for name, m in maps.items():
        rows_of = n if name in ("q", "dO") else kv_len
        assert m["dims"] == (d8, rows_of, h, b)
        assert m["box"] == (64, 128 if name in res else 64, 1, 1), (name, m["box"])
        inner = m["box"][0] * m["element_bytes"]
        assert inner <= m["swizzle_bytes"] == 128 and inner % 16 == 0
        assert all(1 <= x <= 256 for x in m["box"])
        assert all(st % 16 == 0 and 0 < st < 2**40 for st in m["strides_bytes"])
        assert all(x < 2**32 for x in m["dims"])
    assert set(maps) == set(res + streamed)


@pytest.mark.parametrize("dtype,d,route", [(torch.bfloat16, 8, "bf16_wgmma"),
                                           (torch.bfloat16, 128, "bf16_wgmma"),
                                           (torch.bfloat16, 136, "bf16"),
                                           (torch.bfloat16, 256, "bf16"),
                                           (torch.float32, 64, "fp32"),
                                           (torch.float32, 264, "wide"),
                                           (torch.bfloat16, 320, "wide")])
def test_bwd_routes_by_dtype_and_head_width(dtype, d, route):
    """Both backward kernels take one route per dtype and head width: bf16
    on wgmma up to d = 128 and on mma.sync up to 256, fp32 on 3xTF32 up to
    256, the wide kernels above; the plan names the same route."""
    assert tattn.bwd_route_id(dtype, d) == route
    for kind in ("dq", "dkv"):
        assert tattn.flash_bwd_plan(kind, dtype, 2, 100, 3, d)["route"] == route


def _sw128(addr):
    """The 128-byte swizzle: bits 4-6 of a shared-memory address (its
    16-byte piece of a 128-byte row) XOR-ed with bits 7-9 (the row mod 8)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_tile_byte(row, dim, box_bytes):
    """Where TMA puts bf16 element (row, dim) of a tile loaded as boxes of
    64 dims (128-byte rows, box_bytes apart) in the 128-byte swizzle, from a
    1024-byte-aligned base."""
    return _sw128((dim // 64) * box_bytes + row * 128 + (dim % 64) * 2)


def _mn_major_byte(start, lbo, sbo, k, n):
    """The byte a wgmma descriptor in the 128-byte swizzle reads for element
    (k, n) of an MN-major (transposed) bf16 B operand: the canonical layout
    ((8, 8, N / 64), (8, K / 8)) : ((2 bytes, 16 bytes, LBO), (128 bytes,
    SBO)) from the descriptor's start, then swizzled (PTX ISA, wgmma shared
    memory matrix layouts; mma_sm90.cuh wgmma_desc_sw128)."""
    return _sw128(start + (n % 64) * 2 + (n // 64) * lbo + (k % 8) * 128 + (k // 8) * sbo)


def _k_major_byte(start, sbo, mn, k):
    """The same for element (mn, k < 16) of a K-major operand, k contiguous
    in a 128-byte row: ((8, M / 8), 16) : ((128 bytes, SBO), 2 bytes)."""
    return _sw128(start + (mn % 8) * 128 + (mn // 8) * sbo + k * 2)


@pytest.mark.parametrize("n_dims", [64, 128])
def test_tnspb_descriptor_reads_each_b_element_from_its_tma_byte(n_dims):
    """The backward's transposed B operands (K of dS K; dO and Q of P^T dO
    and dS^T Q) are streamed tiles of 64 rows x n_dims dims that TMA wrote in
    boxes of 64 dims: k-step kk's descriptor (tnspb_desc: start at row
    16 kk, LBO one 8 KB box to the next, SBO one 8-row group, 1024 bytes)
    reads B[k][n] = tile[16 kk + k][n] for every k < 16 and n < n_dims. With
    LBO and SBO swapped it reads other bytes."""
    box = 64 * 128
    for lbo, sbo, right in ((box, 1024, True), (1024, box, False)):
        wrong = 0
        for kk in range(4):
            start = kk * 16 * 128
            for k in range(16):
                for n in range(n_dims):
                    got = _mn_major_byte(start, lbo, sbo, k, n)
                    wrong += got != _tma_tile_byte(16 * kk + k, n, box)
        assert (wrong == 0) == right, (lbo, sbo, wrong)


@pytest.mark.parametrize("rows,dims", [(64, 64), (64, 128), (128, 128)])
def test_k_major_descriptor_reads_each_element_from_its_tma_byte(rows, dims):
    """S = Q K^T, dP = dO V^T and their transposes take both operands
    K-major: the descriptor of k-step kk of a warpgroup's 64 rows starts at
    box kk / 4, 32 bytes a k-step inside the swizzled row (SBO 1024), and
    reads element (mn, k) = tile[row0 + mn][16 kk + k] for both warpgroups'
    rows of a resident tile of 128 rows and a streamed tile of 64."""
    box = rows * 128
    for row0 in range(0, rows, 64):
        for kk in range(dims // 16):
            start = (kk // 4) * box + row0 * 128 + (kk % 4) * 32
            for mn in range(64):
                for k in range(16):
                    assert _k_major_byte(start, 1024, mn, k) == _tma_tile_byte(
                        row0 + mn, 16 * kk + k, box)


def test_wgmma_bwd_accumulators_split_hi_lo_are_the_transposed_a_operands():
    """dK/dV: the accumulators of S^T and dP^T (64 keys x 64 queries of a
    warpgroup) packed by pack_split_a are the A registers of P^T dO and
    dS^T Q: k-step kk's register 2 hf + rr holds accumulators 4c + 2rr and
    4c + 2rr + 1 of n-tile c = 2kk + hf, hi and lo each. Through the two
    fragment layouts every packed value lands at its own (key, query), hi
    is the value rounded to bf16, hi + lo carries it to about 2^-16 of
    itself; and accumulator e of a thread is query 8 (e / 4) + 2t + e % 2,
    the column whose LSE and D the kernel reads, at key g + 8 ((e / 2) % 2)."""
    rng = np.random.default_rng(1)
    st = rng.standard_normal((64, 64)).astype(np.float32) * 3.0
    hi = np.full((64, 64), np.nan, dtype=np.float32)
    lo = np.full((64, 64), np.nan, dtype=np.float32)

    def split(x):
        h = torch.tensor(x).to(torch.bfloat16).float()
        return h.item(), (torch.tensor(x) - h).to(torch.bfloat16).float().item()

    for warp in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            regs = [st[_wgmma_acc_pos(warp, lane, e)] for e in range(32)]
            for e in range(32):
                assert _wgmma_acc_pos(warp, lane, e) == (16 * warp + g + 8 * (e // 2 % 2),
                                                         8 * (e // 4) + 2 * t + e % 2)
            for kk in range(4):
                for hf in range(2):
                    for rr in range(2):
                        c = 2 * kk + hf
                        for half in range(2):
                            key, k = _wgmma_a_pos(warp, lane, 2 * hf + rr, half)
                            hi[key, 16 * kk + k], lo[key, 16 * kk + k] = split(
                                regs[4 * c + 2 * rr + half])
    assert np.array_equal(hi, torch.from_numpy(st).to(torch.bfloat16).float().numpy())
    assert np.abs(hi + lo - st).max() <= 2.0**-16 * np.abs(st).max()


def test_wgmma_serialized_names_each_kernel():
    """ptxas's warnings that it serialized a kernel's wgmma (C75xx), by the
    kernel's name; one that names no function gives None; other lines give
    nothing."""
    from ldm3d_torch.ops._kernels import wgmma_serialized

    log = (
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to the presence of Extern calls in the function "
        "'_ZN12_GLOBAL__N_130flash_bwd_dq_bf16_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_"
        "PKfS3_P13__nv_bfloat16iiiiff'\n"
        "ptxas warning : (C7520) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to non wgmma instructions defining accumulator registers\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n")
    assert wgmma_serialized(log) == {"flash_bwd_dq_bf16_wgmma_kernel<64>", None}
    assert wgmma_serialized("ptxas info    : Used 168 registers\n") == set()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGMMA_BWD_CASES, ids=lambda s: "x".join(map(str, s)))
def test_wgmma_bwd_plan_is_the_cuda_libraries_plan_on_card(shape):
    """ldm3d_flash_bwd_plan, the plan the backward's launches read, equals
    flash_bwd_plan for dQ and dK/dV, tensor maps included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel library is built there")
    import ctypes

    from ldm3d_torch.ops._kernels import flash_bwd_library

    b, n, h, d = shape[:4]
    kv_len = shape[4] if len(shape) > 4 else n
    d8 = -(-d // 8) * 8
    strides = _bwd_strides(shape)
    for kind in ("dq", "dkv"):
        out = (ctypes.c_int64 * 49)()
        assert flash_bwd_library().ldm3d_flash_bwd_plan(
            int(kind == "dkv"), 1, b, h, n, kv_len, d8,
            (ctypes.c_int64 * 12)(*(x for st in strides for x in st)), out) == 0
        py = tattn.flash_bwd_plan(kind, torch.bfloat16, b, n, h, d8, kv_len, strides)
        assert [tattn.BWD_ROUTE_IDS[out[0]], (out[1], out[2]), out[3], out[4]] == [
            py["route"], py["grid"], py["threads"], py["smem_bytes"]]
        assert [tuple(out[5 + 11 * i:16 + 11 * i]) for i in range(4)] == [
            (*m["dims"], *m["strides_bytes"], *m["box"])
            for m in (py["tensor_maps"][x] for x in ("q", "k", "v", "dO"))]


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
    (one launch of it, by name in a CUDA graph of the calls)."""
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
                  (1, 1, 1, 256, 8000), (2, 100, 4, 64, 37), (2, 1000, 8, 64), (2, 125, 16, 64),
                  (2, 100, 2, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_CARD_CASES)
def test_flash_bwd_kernels_match_plain_on_card(dtype, shape):
    """Each dtype's backward route (bf16 on wgmma up to d = 128, on mma.sync
    above; fp32 on 3xTF32) against the plain version: one launch of each
    kernel on its route (the wrappers' route counts), every gradient within
    its limit, and the same bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v, out, lse, do = _attn_case(shape, dt, seed=shape[1])
    route = tattn.bwd_route_id(dt, -(-shape[3] // 8) * 8)
    assert (route == "bf16_wgmma") == (dt == torch.bfloat16 and shape[3] <= 128)
    wrappers = (tattn.flash_attention_bwd_dq, tattn.flash_attention_bwd_dkv)
    before = [(fn.launches, fn.route_launches[route]) for fn in wrappers]
    grads = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    again = tattn.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.route_launches[route]) for fn in wrappers] == [
        (x + 2, y + 2) for x, y in before]
    refs = tattn.attention_bwd_reference(q, k, v, out, lse, do)
    for name, got, repeat, want in zip(("dq", "dk", "dv"), grads, again, refs):
        assert torch.equal(got, repeat), name
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
    kernel: at d = 64 the bf16 wgmma kernels in bf16 (not the mma.sync
    pair) and the 3xTF32 tensor-core kernels in fp32 (no scalar kernel), by
    the kernels' names in a CUDA graph of the calls and by the wrappers' route
    counts. A head_dim that is not a multiple of 8 runs zero-padded, one
    launch of each."""
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
        route = "bf16_wgmma" if dtype == torch.bfloat16 else "fp32"
        wrappers = (tattn.flash_attention_bwd_dq, tattn.flash_attention_bwd_dkv)
        before = [(fn.launches, fn.route_launches[route]) for fn in wrappers]
        step()
        torch.cuda.synchronize()
        assert [(fn.launches, fn.route_launches[route]) for fn in wrappers] == [
            (x + 1, y + 1) for x, y in before]
        names[dtype] = _kernel_names(step, "flash_bwd", 2)
        assert all(n == 1 for n in names[dtype].values()), names[dtype]
    for kind in ("dq", "dkv"):
        assert any(f"flash_bwd_{kind}_bf16_wgmma_kernel" in x for x in names[torch.bfloat16])
        assert any(f"flash_bwd_{kind}_tf32x3_mma_kernel" in x for x in names[torch.float32])
    assert not any("tf32" in x or "bf16_mma_kernel" in x for x in names[torch.bfloat16])
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
# the GroupNorm inputs of a stage-1 step (config_train_32g.json's VAE at the
# 64^3 patch, batch 1, and the discriminator's instance norms at 16^3 x 64
# and 8^3 x 128)
GN_STAGE1_SHAPES = [(1, 64, 64, 64, 64), (1, 128, 64, 64, 64), (1, 64, 32, 32, 32),
                    (1, 128, 32, 32, 32), (1, 256, 32, 32, 32), (1, 128, 16, 16, 16),
                    (1, 256, 16, 16, 16), (1, 64, 16, 16, 16), (1, 128, 8, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GN_CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_sums_one_launch_deterministic_and_matches_plain_on_card(dtype, shape):
    """B4 at the flagship's GroupNorm inputs: within 1e-5 of the absolute
    sums of its plain version, the same bits on two runs, and one kernel
    launch a call (by a CUDA graph's kernel nodes), the wrapper counting one."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["channels_last_3d", "contiguous"])
@pytest.mark.parametrize("shape", GN_CARD_SHAPES + GN_STAGE1_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gn_bwd_sums_one_launch_deterministic_and_matches_plain_on_card(dtype, layout, shape):
    """B5 at the flagship's GroupNorm inputs and a stage-1 step's, dy in
    ``layout`` (x channels_last_3d, as the activations are): within 1e-5 of
    the absolute sums of its plain version, the same bits on two runs, and
    one kernel launch a call (by a CUDA graph's kernel nodes), the wrapper counting
    one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    fmt = {"channels_last_3d": torch.channels_last_3d, "contiguous": torch.contiguous_format}[layout]
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device="cuda") * 0.5 + 0.3).to(dt).contiguous(
        memory_format=torch.channels_last_3d)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt).contiguous(memory_format=fmt)
    mean = torch.randn(shape[:2], generator=gen, device="cuda") * 0.3
    inv = torch.rand(shape[:2], generator=gen, device="cuda") + 0.5
    before = tgn.gn_bwd_sums.launches
    got = tgn.gn_bwd_sums(dy, x, mean, inv)
    again = tgn.gn_bwd_sums(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert tgn.gn_bwd_sums.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean[..., None, None, None]) * inv[..., None, None, None]
    for g, w, terms in zip(got, tgn.gn_bwd_sums_reference(dy, x, mean, inv), (dyf, dyf * xhat)):
        assert ((g.double() - w.double()).abs() <= _sum_tol(terms)).all()
    del xf, dyf, xhat
    names = _kernel_names(lambda: tgn.gn_bwd_sums(dy, x, mean, inv), "", 1)
    assert len(names) == 1 and "gn_bwd_sums_onepass" in next(iter(names)), names
    assert next(iter(names.values())) == 1
