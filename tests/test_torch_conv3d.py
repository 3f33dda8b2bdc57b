"""The implicit-GEMM conv (B6): the port's ``conv3d_igemm`` against the JAX one.

On the CPU the port's wrapper runs its plain version, held here against
JAX's Pallas kernel in interpret mode and against ``conv3d_xla`` at
``tests/test_conv3d.py``'s five shapes. Tolerances as JAX's own test: fp32
1e-5 and bf16 2e-2 of the largest |reference|. The ``cuda``-marked test
holds the CUDA kernel against the plain version on the card (fp32 1e-5,
bf16 2^-7 of the largest |plain|: one bf16 ulp, both round the same fp32
sum); run it there with ``python -m pytest --noconftest -m cuda
tests/test_torch_conv3d.py``, which needs no JAX.
"""

import numpy as np
import pytest
import torch

from ldm3d_torch.ops import conv3d as tconv

SHAPES = [
    (1, 3, 8, 8, 8, 8),      # generic tiny
    (2, 4, 8, 16, 16, 8),    # multi-batch, rectangular plane, cout != cin
    (1, 2, 4, 8, 64, 64),    # the lane-starved L0 channel width
    (1, 2, 6, 8, 3, 5),      # odd channel counts
    (1, 1, 4, 8, 8, 8),      # single depth plane (both halo planes zero)
]


def _inputs(shape, seed):
    B, D, H, W, C, CO = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C, CO)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_xla(shape, dtype):
    import jax.numpy as jnp

    from ldm3d_tpu.ops.conv3d import conv3d_igemm, conv3d_xla

    x, w = _inputs(shape, seed=sum(shape))
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    H, W = shape[2], shape[3]
    refs = [np.asarray(conv3d_xla(jx, jw).astype(jnp.float32)),
            np.asarray(conv3d_igemm(jx, jw, tile_m=max(H * W // 2, 8),
                                    interpret=True).astype(jnp.float32))]
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    before = tconv.conv3d_igemm.launches
    out = tconv.conv3d_igemm(tx, tw)
    assert tconv.conv3d_igemm.launches == before  # the CPU runs the plain version
    assert out.dtype == tx.dtype and out.shape == (*shape[:4], shape[5])
    out = out.float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for ref in refs:
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(ref - out).max()) / scale < tol


def test_rejects_untargeted_shapes():
    x = torch.zeros((1, 2, 4, 8, 8))
    with pytest.raises(ValueError, match="3x3x3"):
        tconv.conv3d_igemm(x, torch.zeros((5, 5, 5, 8, 8)))
    with pytest.raises(ValueError, match="C <= 64"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 8, 128)), torch.zeros((3, 3, 3, 128, 128)))
    with pytest.raises(ValueError, match="W % 8"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 12, 8)), torch.zeros((3, 3, 3, 8, 8)))
    with pytest.raises(ValueError, match="no gradient"):
        tconv.conv3d_igemm(x.requires_grad_(), torch.zeros((3, 3, 3, 8, 8)))
    with pytest.raises(ValueError, match="dtype"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 8, 8)),
                           torch.zeros((3, 3, 3, 8, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        tconv.conv3d_igemm(torch.zeros((1, 2, 4, 8, 8), device="meta"),
                           torch.zeros((3, 3, 3, 8, 8), device="meta"))


def test_plain_is_the_padded_tap_sum():
    """conv3d_ref is F.conv3d's SAME cross-correlation, computed in fp32."""
    x, w = _inputs((2, 3, 4, 8, 5, 6), seed=9)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref = torch.nn.functional.conv3d(tx.permute(0, 4, 1, 2, 3), tw.permute(4, 3, 0, 1, 2),
                                     padding=1).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(tconv.conv3d_ref(tx, tw), ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(1, 3, 80, 80, 64, 64), (2, 2, 96, 96, 64, 64)])
def test_cuda_kernel_matches_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, w = (torch.from_numpy(a).to("cuda", getattr(torch, dtype))
            for a in _inputs(shape, seed=sum(shape)))
    before = tconv.conv3d_igemm.launches
    out = tconv.conv3d_igemm(x, w)
    torch.cuda.synchronize()
    assert tconv.conv3d_igemm.launches == before + 1
    ref = tconv.conv3d_ref(x, w).float()
    rel = 2.0**-7 if dtype == "bfloat16" else 1e-5
    assert (out.float() - ref).abs().max().item() <= rel * ref.abs().max().item()
