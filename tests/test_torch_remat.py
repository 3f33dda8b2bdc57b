"""Rematerialisation (``--remat``): the port's ``remat_wrapped`` against the
JAX package's.

Mirrors ``tests/test_remat_policy.py`` case for case (the three modes give
the same gradients in both model families; an unknown mode raises JAX's
``ValueError``), and holds the port to ``ldm3d_tpu`` on the micro preset in
fp32 on the CPU: each remat mode of the VAE, the UNet and a
``mid_depth = 2`` UNet against the JAX model built with the same mode
(its gradient under ``jax.jit``), with the Flax params carried through
``ckpt/from_jax.py``, forward and gradients at atol 1e-4; and the port's remated gradients against its own unremated
ones within 1e-6 of each tensor's largest |g|. What each mode recomputes is
counted too: ``"full"`` reruns the blocks' convolutions in the backward,
``"convs"`` none of them.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_models import ref_jit

from ldm3d_torch.ckpt.from_jax import autoencoder_state_dict_from_jax, unet_state_dict_from_jax
from ldm3d_torch.configs import define_instance
from ldm3d_torch.nn.blocks import ResBlock3D, remat_wrapped
from ldm3d_tpu.configs import ConfigResolver, load_json, preset_path

ATOL = 1e-4
SELF_REL = 1e-6
MODES = [True, "full", "convs"]

torch.set_num_threads(1)


def _cfg(remat=False, mid_depth=0) -> dict:
    cfg = copy.deepcopy(load_json(preset_path("config_micro_cpu.json")))
    cfg["autoencoder_def"]["remat"] = remat
    cfg["diffusion_def"]["remat"] = remat
    cfg["diffusion_def"]["mid_depth"] = mid_depth
    return cfg


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 4, 2)).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    t = np.array([3, 11], np.int32)
    return x, eps, z, t


@pytest.fixture(scope="module")
def params():
    """Flax params of the micro VAE, UNet and mid_depth = 2 UNet (built
    without remat: a mode does not change the tree), the UNets' zero-init
    ``conv_out`` seeded non-zero so every layer reaches the loss."""
    x, _, z, t = _inputs()
    key = jax.random.PRNGKey(0)
    out = {}
    r = ConfigResolver(_cfg())
    ae = r.instantiate("autoencoder_def")
    out["vae"] = jax.device_get(ref_jit(ae.init)({"params": key, "sample": key},
                                                 jnp.asarray(x))["params"])
    rng = np.random.default_rng(1)
    for name, depth in (("unet", 0), ("mid", 2)):
        unet = ConfigResolver(_cfg(mid_depth=depth)).instantiate("diffusion_def")
        p = jax.device_get(ref_jit(unet.init)(key, jnp.asarray(z), jnp.asarray(t))["params"])
        k = p["conv_out"]["kernel"]
        p["conv_out"]["kernel"] = 0.05 * rng.standard_normal(k.shape).astype(np.float32)
        out[name] = p
    return out


def _jax_vae(remat, params):
    x, eps, _, _ = _inputs()
    ae = ConfigResolver(_cfg(remat)).instantiate("autoencoder_def")

    def loss(p):
        mu, sigma = ae.apply({"params": p}, x, method="encode")
        recon = ae.apply({"params": p}, mu + sigma * eps, method="decode")
        return jnp.mean((recon - x) ** 2) + 1e-3 * jnp.mean(mu ** 2 + sigma ** 2), recon

    (value, recon), grads = ref_jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), np.asarray(recon), grads


def _port_vae(remat, params):
    x, eps, _, _ = _inputs()
    ae = define_instance(SimpleNamespace(**_cfg(remat)), "autoencoder_def")
    ae.load_state_dict(autoencoder_state_dict_from_jax(params, ae))
    xt = torch.from_numpy(x)
    recon, mu, sigma = ae(xt, torch.from_numpy(eps))
    loss = torch.mean((recon - xt) ** 2) + 1e-3 * torch.mean(mu ** 2 + sigma ** 2)
    loss.backward()
    return (float(loss.detach()), recon.detach().numpy(),
            {n: p.grad.clone() for n, p in ae.named_parameters()}, ae)


def _jax_unet(remat, params, depth):
    _, _, z, t = _inputs()
    unet = ConfigResolver(_cfg(remat, depth)).instantiate("diffusion_def")

    def loss(p):
        out = unet.apply({"params": p}, z, t)
        return jnp.mean(out ** 2), out

    (value, out), grads = ref_jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(value), np.asarray(out), grads


def _port_unet(remat, params, depth):
    _, _, z, t = _inputs()
    unet = define_instance(SimpleNamespace(**_cfg(remat, depth)), "diffusion_def")
    unet.load_state_dict(unet_state_dict_from_jax(params, unet))
    out = unet(torch.from_numpy(z), torch.from_numpy(t))
    loss = torch.mean(out ** 2)
    loss.backward()
    return (float(loss.detach()), out.detach().numpy(),
            {n: p.grad.clone() for n, p in unet.named_parameters()}, unet)


def _assert_grads_match_jax(port_model, port_grads, jax_grads, bridge):
    """The JAX gradient tree carried through the weight bridge, as the
    params are, then held to the port's gradients at ATOL."""
    ref = bridge(jax.device_get(jax_grads), port_model)
    assert set(ref) >= set(port_grads)
    for name, g in port_grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=ATOL, rtol=0, err_msg=name)


def _assert_same_grads(a: dict, b: dict):
    """Each tensor within 1e-6 of its largest |g| (exactly equal on the CPU)."""
    assert a.keys() == b.keys()
    for name in a:
        scale = max(float(a[name].abs().max()), 1e-30)
        assert float((a[name] - b[name]).abs().max()) <= SELF_REL * scale, name


@pytest.mark.parametrize("mode", ["full", "convs"])
def test_vae_remat_matches_jax(mode, params):
    jv, jrecon, jg = _jax_vae(mode, params["vae"])
    pv, precon, pg, ae = _port_vae(mode, params["vae"])
    np.testing.assert_allclose(precon, jrecon, atol=ATOL, rtol=0)
    assert abs(pv - jv) <= ATOL
    _assert_grads_match_jax(ae, pg, jg, autoencoder_state_dict_from_jax)


@pytest.mark.parametrize("mode", ["full", "convs"])
@pytest.mark.parametrize("depth", [0, 2], ids=["unet", "mid_depth2"])
def test_unet_remat_matches_jax(mode, depth, params):
    p = params["unet" if depth == 0 else "mid"]
    jv, jout, jg = _jax_unet(mode, p, depth)
    pv, pout, pg, unet = _port_unet(mode, p, depth)
    np.testing.assert_allclose(pout, jout, atol=ATOL, rtol=0)
    assert abs(pv - jv) <= ATOL
    _assert_grads_match_jax(unet, pg, jg, unet_state_dict_from_jax)


def test_autoencoder_remat_modes_grad_parity(params):
    _, recon_f, g_false, _ = _port_vae(False, params["vae"])
    for mode in MODES:
        _, recon_m, g_m, _ = _port_vae(mode, params["vae"])
        np.testing.assert_array_equal(recon_m, recon_f)
        _assert_same_grads(g_false, g_m)


@pytest.mark.parametrize("depth", [0, 2], ids=["unet", "mid_depth2"])
def test_unet_remat_modes_grad_parity(depth, params):
    p = params["unet" if depth == 0 else "mid"]
    _, out_f, g_false, _ = _port_unet(False, p, depth)
    for mode in MODES:
        _, out_m, g_m, _ = _port_unet(mode, p, depth)
        np.testing.assert_array_equal(out_m, out_f)
        _assert_same_grads(g_false, g_m)


def test_remat_wrapped_rejects_unknown_mode():
    block = ResBlock3D(4, 4, 2)
    with pytest.raises(ValueError, match="remat must be"):
        remat_wrapped(block, "bogus")
    with pytest.raises(ValueError, match="remat must be"):
        define_instance(SimpleNamespace(**_cfg("bogus")), "autoencoder_def")
    ae = define_instance(SimpleNamespace(**_cfg()), "autoencoder_def")
    with pytest.raises(ValueError, match="remat must be"):
        ae.remat = "bogus"


def test_remat_wrapped_is_the_block_without_remat_or_autograd():
    block = ResBlock3D(4, 8, 2)
    assert remat_wrapped(block, False) is block
    assert remat_wrapped(block, None) is block
    x = torch.randn(1, 4, 4, 4, 4)
    with torch.no_grad():
        np.testing.assert_array_equal(remat_wrapped(block, "full")(x).numpy(), block(x).numpy())


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.convs += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode,reruns", [(False, 0), ("full", 2), ("convs", 0)])
def test_backward_reruns_the_convolutions_only_under_full(mode, reruns):
    """A ResBlock with a shortcut has three convolutions: ``"full"`` reruns
    conv1 and conv2 in the backward (the shortcut's output feeds no
    backward, and the rerun stops once what the backward needs is back),
    ``"convs"`` keeps their outputs (JAX's ``resblock_conv`` tags), no
    remat saves everything."""
    torch.manual_seed(0)
    block = ResBlock3D(4, 8, 2)
    x = torch.randn(1, 4, 4, 4, 4, requires_grad=True)
    y = remat_wrapped(block, mode)(x)
    counter = _CountConvs()
    with counter:
        y.sum().backward()
    assert counter.convs == reruns  # a convolution's backward is convolution_backward
