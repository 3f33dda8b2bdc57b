"""Parity of the port's blocks (``ldm3d_torch/nn/blocks.py``) with the JAX
package's (``ldm3d_tpu/nn/blocks.py``).

Each case builds the Flax block, initialises it from a fixed key, carries its
params into the torch block through the weight bridge
(``ldm3d_torch.ckpt.from_jax``), feeds both the same numpy input and compares
the outputs in fp32 on the CPU at atol 1e-4 (the bar
``tests/test_golden_torch.py`` sets for convs and norms): the only differences
are summation order and the reassociated forms of the few-output conv and the
fused upsample-conv.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import ref_jit

from ldm3d_torch.ckpt.from_jax import state_dict_from_jax
from ldm3d_torch.nn import blocks as tb
from ldm3d_tpu.nn import blocks as jb

torch.set_num_threads(1)

ATOL = 1e-4


def _to_torch(x: np.ndarray) -> torch.Tensor:
    return tb.to_channels_last(torch.from_numpy(x))


def _to_numpy(y: torch.Tensor) -> np.ndarray:
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


# name -> (JAX module, torch module, input channels, spatial size, has temb)
CASES = {
    "conv_same": (lambda: jb.Conv3D(12), lambda: tb.Conv3D(6, 12), 6, 6, False),
    "conv_down": (lambda: jb.Conv3D(8, stride=2, padding="down"),
                  lambda: tb.Conv3D(6, 8, stride=2, padding="down"), 6, 7, False),
    "conv_1x1": (lambda: jb.Conv3D(5, kernel=1, padding="valid"),
                 lambda: tb.Conv3D(6, 5, kernel=1, padding="valid"), 6, 5, False),
    "conv_few_out": (lambda: jb.Conv3D(2), lambda: tb.Conv3D(32, 2), 32, 6, False),
    "groupnorm": (lambda: jb.GroupNorm32(4), lambda: tb.GroupNorm32(12, 4), 12, 5, False),
    "resblock": (lambda: jb.ResBlock3D(8, num_groups=4),
                 lambda: tb.ResBlock3D(8, 8, 4), 8, 6, False),
    "resblock_shortcut": (lambda: jb.ResBlock3D(16, num_groups=4),
                          lambda: tb.ResBlock3D(8, 16, 4), 8, 6, False),
    "time_resblock": (lambda: jb.TimeResBlock3D(16, num_groups=4),
                      lambda: tb.TimeResBlock3D(8, 16, 12, 4), 8, 5, True),
    "attention_single_head": (lambda: jb.AttentionBlock3D(num_groups=4),
                              lambda: tb.AttentionBlock3D(16, 0, 4), 16, 5, False),
    "attention_multi_head": (lambda: jb.AttentionBlock3D(num_head_channels=8, num_groups=4),
                             lambda: tb.AttentionBlock3D(32, 8, 4), 32, 4, False),
    "downsample": (lambda: jb.Downsample3D(8), lambda: tb.Downsample3D(8, 8), 8, 6, False),
    "upsample": (lambda: jb.Upsample3D(8), lambda: tb.Upsample3D(12, 8), 12, 4, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    make_jax, make_torch, cin, size, has_temb = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal((2, size, size, size, cin), dtype=np.float32)
    args = (jnp.asarray(x),)
    if has_temb:
        temb = rng.standard_normal((2, 12), dtype=np.float32)
        args += (jnp.asarray(temb),)
    jmod = make_jax()
    params = ref_jit(jmod.init)(jax.random.PRNGKey(1), *args)["params"]
    if name == "groupnorm":  # non-trivial affine
        params = {"scale": jnp.asarray(rng.standard_normal(cin, dtype=np.float32)),
                  "bias": jnp.asarray(rng.standard_normal(cin, dtype=np.float32))}
    ref = np.asarray(ref_jit(jmod.apply)({"params": params}, *args))

    tmod = make_torch()
    tmod.load_state_dict(state_dict_from_jax(jax.device_get(params), tmod))
    targs = (_to_torch(x),) + ((torch.from_numpy(temb),) if has_temb else ())
    with torch.no_grad():
        out = _to_numpy(tmod(*targs))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dim", [16, 33])
def test_sinusoidal_time_embedding_matches_jax(dim):
    t = np.array([0, 3, 250, 999], np.int32)
    ref = np.asarray(jb.sinusoidal_time_embedding(jnp.asarray(t), dim))
    out = tb.sinusoidal_time_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 7, 999], np.int32)
    jmod = jb.TimestepEmbedding(16, 64)
    params = ref_jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(t))["params"]
    ref = np.asarray(ref_jit(jmod.apply)({"params": params}, jnp.asarray(t)))
    tmod = tb.TimestepEmbedding(16, 64)
    tmod.load_state_dict(state_dict_from_jax(jax.device_get(params), tmod))
    with torch.no_grad():
        out = tmod(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_groupnorm_bf16_keeps_fp32_statistics():
    """Under bf16 compute the statistics stay fp32 and the output is bf16: a
    large mean offset would wipe out a bf16 E[x^2]-mean^2 but not an fp32 one.
    Tolerance 0.35: the input's and the scaled input's bf16 roundings at
    magnitude 50 (0.125 each) before the affine cancels the mean, plus the
    output's rounding; a bf16 variance would be off by orders more."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, 4, 4, 4, 8), dtype=np.float32) + 50.0)
    gn = tb.GroupNorm32(8, 2)
    out = gn(_to_torch(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = gn(_to_torch(x))
    np.testing.assert_allclose(_to_numpy(out.float()), _to_numpy(ref), atol=0.35)
