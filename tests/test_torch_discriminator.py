"""Parity of the port's ``PatchDiscriminator3D`` with the JAX package's.

The Flax discriminator's params (numpy with a seed, of its tree's shapes)
reach the port through ``ldm3d_torch.ckpt.from_jax``; both get the same
numpy volumes, fp32 on the CPU. Tolerances: every feature map and the
logits within 1e-4 (a few layers of fp32 convs and instance norms); the
LSGAN discriminator loss's gradients with respect to D's params within 1e-4
of the largest |g| over all of D's params (the bias of a conv that an
instance norm follows has a gradient of zero, so its leaf holds rounding
noise only, and a bound relative to that leaf's own largest |g| would
compare noise). Sizes: even, odd (flax ``SAME`` pads an odd
dim (1, 2) at stride 2) and non-cubic.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from test_torch_models import ref_jit
from test_torch_stage1 import _fill

from ldm3d_torch.ckpt import discriminator_state_dict_from_jax
from ldm3d_torch.configs import define_instance
from ldm3d_torch.losses import lsgan_discriminator_loss
from ldm3d_torch.nn import PatchDiscriminator3D as PortDisc
from ldm3d_torch.nn.discriminator import same_pads
from ldm3d_tpu.losses import lsgan_discriminator_loss as jax_d_loss
from ldm3d_tpu.nn import PatchDiscriminator3D as JaxDisc

torch.set_num_threads(1)

ATOL = 1e-4
GRAD_REL = 1e-4


def _pair(shape, layers=3, channels=8, seed=0):
    jd = JaxDisc(num_layers_d=layers, channels=channels)
    probe = jnp.zeros((1, *shape, 1))
    params = _fill(jax.eval_shape(jd.init, jax.random.PRNGKey(0), probe)["params"], seed)
    td = PortDisc(num_layers_d=layers, channels=channels)
    td.load_state_dict(discriminator_state_dict_from_jax(params, td))
    return jd, params, td


@pytest.mark.parametrize("n", range(1, 10))
@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_are_flax_same(n, stride):
    ref = lax.padtype_to_pads((n,), (4,), (stride,), "SAME")[0]
    assert same_pads(n, 4, stride) == tuple(ref)


@pytest.mark.parametrize("shape", [(16, 16, 16), (15, 15, 15), (13, 16, 11)],
                         ids=["even", "odd", "mixed"])
def test_features_and_logits_match_jax(shape):
    jd, params, td = _pair(shape, seed=sum(shape))
    x = np.random.default_rng(1).uniform(0, 1, (2, *shape, 1)).astype(np.float32)
    ref = ref_jit(jd.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = td(torch.from_numpy(x))
    assert len(out) == len(ref) == 4
    for i, (o, r) in enumerate(zip(out, ref)):
        assert tuple(o.shape) == r.shape, i
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, err_msg=f"feature {i}")


@pytest.mark.parametrize("shape", [(16, 16, 16), (15, 15, 15)], ids=["even", "odd"])
def test_d_loss_gradients_match_jax(shape):
    """The gradient of 0.5 [D(fake)^2 + (D(real) - 1)^2] with respect to D's
    params: the convs' and, through the instance norms' closed-form
    backward, every layer's."""
    jd, params, td = _pair(shape, seed=7)
    rng = np.random.default_rng(2)
    fake, real = (rng.uniform(0, 1, (2, *shape, 1)).astype(np.float32) for _ in range(2))

    def loss_fn(p):
        return jax_d_loss(jd.apply({"params": p}, jnp.asarray(fake))[-1],
                          jd.apply({"params": p}, jnp.asarray(real))[-1])

    ref_loss, ref_grads = ref_jit(jax.value_and_grad(loss_fn))(params)
    loss = lsgan_discriminator_loss(td(torch.from_numpy(fake))[-1], td(torch.from_numpy(real))[-1])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = discriminator_state_dict_from_jax(jax.device_get(ref_grads), td)
    largest = max(g.abs().max().item() for g in ref.values())
    for name, p in td.named_parameters():
        worst = (p.grad - ref[name]).abs().max().item() / largest
        assert worst <= GRAD_REL, (name, worst)
    # the biases before the norms: zero up to rounding in both
    assert ref["conv_1.bias"].abs().max().item() <= 1e-6 * largest


@pytest.mark.parametrize("target", ["ldm3d_torch.nn.PatchDiscriminator3D",
                                    "ldm3d_tpu.nn.PatchDiscriminator3D",
                                    "monai.networks.nets.PatchDiscriminator"])
def test_registry_aliases_build_the_port(target):
    ns = SimpleNamespace(d={"_target_": target, "spatial_dims": 3, "num_layers_d": 2,
                            "channels": 4, "in_channels": 1, "out_channels": 1,
                            "norm": "INSTANCE"})
    d = define_instance(ns, "d")
    assert isinstance(d, PortDisc) and d.num_layers_d == 2
    assert set(d.state_dict()) == {"conv_0.weight", "conv_0.bias", "conv_1.weight",
                                   "conv_1.bias", "conv_out.weight", "conv_out.bias"}


def test_from_config_refuses_what_it_does_not_support():
    with pytest.raises(ValueError, match="spatial_dims"):
        PortDisc.from_config(spatial_dims=2)
    with pytest.raises(ValueError, match="INSTANCE"):
        PortDisc.from_config(norm="BATCH")


def test_bridge_refuses_a_missing_or_extra_leaf():
    _, params, td = _pair((8, 8, 8), layers=2, channels=4)
    missing = jax.tree_util.tree_map(lambda x: x, params)
    del missing["conv_1"]["bias"]
    with pytest.raises(ValueError, match="unfilled.*conv_1.bias"):
        discriminator_state_dict_from_jax(missing, td)
    extra = jax.tree_util.tree_map(lambda x: x, params)
    extra["norm_1"] = {"scale": np.ones(8, np.float32)}
    with pytest.raises(ValueError, match="unconsumed.*norm_1/scale"):
        discriminator_state_dict_from_jax(extra, td)
