"""Parity of the port's 2.5D LPIPS (``ldm3d_torch/nn/lpips.py``) with the JAX
package's (``ldm3d_tpu/nn/lpips.py``).

The Flax LPIPS params (numpy with a seed, of its tree's shapes: the
SqueezeNet trunk's 2D conv kernels ``(H, W, I, O)`` and ``lin_{i}``) reach
the port through ``ldm3d_torch.ckpt.from_jax``; fp32 on the CPU.
Tolerances: the max pool and the slice gather exact (they move values); the
seven trunk stages, the LPIPS distance and the 2.5D loss within 1e-5
relative (fp32 convs summed in other orders), the 2.5D loss with the slice
indices the JAX function draws from its key.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import ref_jit
from test_torch_stage1 import lpips_params

from ldm3d_torch.ckpt import lpips_state_dict_from_jax
from ldm3d_torch.nn import LPIPS as PortLPIPS
from ldm3d_torch.nn import lpips as T
from ldm3d_tpu.nn import LPIPS as JaxLPIPS
from ldm3d_tpu.nn import SqueezeNetFeatures as JaxSqueeze
from ldm3d_tpu.nn import lpips as J

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    params = lpips_params(seed=5)
    tl = PortLPIPS()
    tl.load_state_dict(lpips_state_dict_from_jax(params, tl))
    return params, tl.requires_grad_(False)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("n", range(1, 10))
def test_maxpool_matches_jax_exactly(n):
    x = np.random.default_rng(n).standard_normal((2, n, n + 1, 3)).astype(np.float32)
    ref = np.asarray(J._maxpool(jnp.asarray(x)))
    out = T._maxpool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("size", [16, 23])
def test_squeezenet_stages_match_jax(pair, size):
    params, tl = pair
    x = (_images((2, size, size, 3), size) - 0.5) * 4.0
    ref = ref_jit(JaxSqueeze().apply)({"params": params["squeeze"]}, jnp.asarray(x))
    with torch.no_grad():
        out = tl.squeeze(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(out) == len(ref) == 7
    for i, (o, r) in enumerate(zip(out, ref)):
        r = np.asarray(r)
        assert tuple(o.permute(0, 2, 3, 1).shape) == r.shape, i
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), r, rtol=RTOL,
                                   atol=RTOL * np.abs(r).max(), err_msg=f"stage {i + 1}")


@pytest.mark.parametrize("channels", [1, 3])
def test_lpips_distance_matches_jax(pair, channels):
    params, tl = pair
    x, y = _images((3, 16, 16, channels), 1), _images((3, 16, 16, channels), 2)
    ref = np.asarray(ref_jit(JaxLPIPS().apply)({"params": params}, jnp.asarray(x),
                                                jnp.asarray(y)))
    with torch.no_grad():
        out = tl(torch.from_numpy(x), torch.from_numpy(y))
    assert out.dtype == torch.float32 and out.shape == (3,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_slices_along_axis_match_jax_exactly(axis):
    vol = _images((2, 5, 6, 7, 1), 3)
    idx = np.array([4, 0, 2])
    ref = np.asarray(J._slices_along_axis(jnp.asarray(vol), axis, jnp.asarray(idx)))
    out = T._slices_along_axis(torch.from_numpy(vol), axis, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_perceptual_loss_25d_matches_jax_with_its_indices(pair):
    """The JAX function draws per axis ``rng, sub = split(rng)`` and
    ``choice(sub, n, (ceil(0.2 n),), replace=False)``; the port gets those
    indices."""
    params, tl = pair
    x, y = _images((2, 16, 12, 10, 1), 4), _images((2, 16, 12, 10, 1), 5)
    key = jax.random.PRNGKey(6)
    jl = JaxLPIPS()
    ref = ref_jit(lambda a, b, k: J.perceptual_loss_25d(
        lambda u, v: jl.apply({"params": params}, u, v), a, b, k))(jnp.asarray(x),
                                                                   jnp.asarray(y), key)
    idx, rng = [], key
    for n in x.shape[1:4]:
        rng, sub = jax.random.split(rng)
        idx.append(torch.from_numpy(np.array(jax.random.choice(
            sub, n, shape=(math.ceil(0.2 * n),), replace=False)).astype(np.int64)))
    with torch.no_grad():
        out = T.perceptual_loss_25d(tl, torch.from_numpy(x), torch.from_numpy(y), idx)
    np.testing.assert_allclose(out.item(), float(ref), rtol=RTOL)


def test_draw_slices_takes_ceil_ratio_distinct_indices_from_the_generator():
    shape = (1, 16, 12, 3, 1)
    a = T.draw_slices(torch.Generator().manual_seed(0), shape, 0.2)
    b = T.draw_slices(torch.Generator().manual_seed(0), shape, 0.2)
    assert [len(s) for s in a] == [4, 3, 1]
    for s, n in zip(a, shape[1:4]):
        assert len(set(s.tolist())) == len(s) and 0 <= int(s.min()) and int(s.max()) < n
    assert all(torch.equal(s, t) for s, t in zip(a, b))


def test_fixed_seed_init_is_the_same_every_time():
    one, two = T.init_lpips_(PortLPIPS()), T.init_lpips_(PortLPIPS())
    assert all(torch.equal(a, b) for a, b in zip(one.state_dict().values(),
                                                 two.state_dict().values()))
    assert torch.equal(one.lin_3, torch.ones(384))


def test_bridge_transposes_2d_kernels_and_keeps_lin(pair):
    params, tl = pair
    sd = tl.state_dict()
    k = params["squeeze"]["fire2"]["expand3"]["kernel"]            # (H, W, I, O)
    np.testing.assert_array_equal(sd["squeeze.fire2.expand3.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["lin_6"].numpy(), params["lin_6"])
    with pytest.raises(ValueError, match="unknown leaf 'lin_x'"):
        lpips_state_dict_from_jax({**params, "lin_x": np.ones(3, np.float32)}, tl)
