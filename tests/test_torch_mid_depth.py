"""Parity of the port's ``mid_depth`` stack (``MidBlock3D``) with the JAX package.

The JAX UNet builds its uniform bottleneck stack with ``nn.scan``, so every
``mid_stack`` leaf carries a leading ``mid_depth`` axis; the weight bridge
splits it into the port's ``mid_stack.{i}``. On the micro preset with
``mid_depth = 2`` (fp32, the CPU): the forward within 1e-4, and one stage-2
step (latent space) with the loss and ``grad_norm`` within 1e-5 relative,
as the stage-2 step tests hold them (``tests/test_torch_train.py``).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import ref_jit
from test_torch_train import LR, SCALE, _assert_params_close, _jax_draws

from ldm3d_torch.ckpt.from_jax import unet_state_dict_from_jax
from ldm3d_torch.configs import define_instance
from ldm3d_torch.diffusion import DDPMScheduler as PortDDPM
from ldm3d_torch.nn.blocks import to_channels_last
from ldm3d_torch.nn.diffusion_unet import MidBlock3D
from ldm3d_torch.training import (
    Stage2Config,
    TrainState,
    build_lr_schedule,
    make_diffusion_optimizer,
    make_stage2_train_step_latents,
)
from ldm3d_tpu.configs import ConfigResolver, load_json, preset_path
from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
from ldm3d_tpu.training import Stage2Config as JaxStage2Config
from ldm3d_tpu.training import TrainState as JaxTrainState
from ldm3d_tpu.training import build_lr_schedule as jax_build_lr_schedule
from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
from ldm3d_tpu.training.stage2 import make_stage2_train_step_latents as jax_latents_step

ATOL = 1e-4
DEPTH = 2

torch.set_num_threads(1)


def _cfg(depth: int = DEPTH) -> dict:
    cfg = copy.deepcopy(load_json(preset_path("config_micro_cpu.json")))
    cfg["diffusion_def"]["mid_depth"] = depth
    return cfg


def _pair(depth: int = DEPTH, seed: int = 0):
    """The JAX UNet with seeded params (a non-zero ``conv_out``) and the
    port's UNet from the same config carrying them."""
    cfg = _cfg(depth)
    junet = ConfigResolver(cfg).instantiate("diffusion_def")
    latent = [p // 4 for p in cfg["diffusion_train"]["patch_size"]]
    params = jax.device_get(ref_jit(junet.init)(jax.random.PRNGKey(seed),
                                                jnp.zeros((1, *latent, junet.in_channels)),
                                                jnp.zeros((1,), jnp.int32))["params"])
    kernel = params["conv_out"]["kernel"]
    params["conv_out"]["kernel"] = 0.05 * np.random.default_rng(seed).standard_normal(
        kernel.shape).astype(np.float32)
    tunet = define_instance(SimpleNamespace(**cfg), "diffusion_def")
    tunet.load_state_dict(unet_state_dict_from_jax(params, tunet))
    return cfg, junet, params, tunet.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_stack_layout_and_from_config(pair):
    cfg, junet, params, tunet = pair
    assert junet.mid_depth == tunet.mid_depth == DEPTH
    assert len(tunet.mid_stack) == DEPTH and all(isinstance(b, MidBlock3D)
                                                  for b in tunet.mid_stack)
    stacked = jax.tree_util.tree_leaves(params["mid_stack"])
    assert all(leaf.shape[0] == DEPTH for leaf in stacked)
    port_keys = [k for k in tunet.state_dict() if k.startswith("mid_stack.")]
    assert len(port_keys) == DEPTH * len(stacked)
    assert {k.split(".")[1] for k in port_keys} == {str(i) for i in range(DEPTH)}
    # layer i of a stacked leaf is the port's mid_stack.{i} parameter
    k = params["mid_stack"]["res"]["conv1"]["kernel"]
    for i in range(DEPTH):
        np.testing.assert_array_equal(
            tunet.mid_stack[i].res.conv1.weight.detach().numpy(), k[i].transpose(4, 3, 0, 1, 2))
    with torch.device("meta"):
        shallow = define_instance(SimpleNamespace(**_cfg(0)), "diffusion_def")
    assert shallow.mid_depth == 0 and not any(k.startswith("mid_stack")
                                              for k in shallow.state_dict())


def test_forward_matches_jax(pair):
    cfg, junet, params, tunet = pair
    latent = [p // 4 for p in cfg["diffusion_train"]["patch_size"]]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *latent, junet.in_channels), dtype=np.float32)
    t = np.array([3, 11], np.int32)
    ref = np.asarray(ref_jit(junet.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = tunet(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_staged_bottleneck_matches_jax_methods(pair):
    """``mid_entry`` / ``mid_stack_apply`` / ``mid_exit`` are JAX's split."""
    cfg, junet, params, tunet = pair
    c = cfg["diffusion_def"]["channels"][-1]
    rng = np.random.default_rng(3)
    h = rng.standard_normal((1, 2, 2, 2, c), dtype=np.float32)
    t = np.array([5], np.int32)
    v = {"params": params}
    temb = ref_jit(lambda v, a: junet.apply(v, a, method="time_embedding"))(v, jnp.asarray(t))
    ref_entry = ref_jit(lambda v, a, e: junet.apply(v, a, e, method="mid_entry"))(
        v, jnp.asarray(h), temb)
    ref_stack = ref_jit(lambda v, a, e: junet.apply(v, a, e, method="mid_stack_apply"))(
        v, ref_entry, temb)
    ref_exit = ref_jit(lambda v, a, e: junet.apply(v, a, e, method="mid_exit"))(
        v, ref_stack, temb)
    with torch.no_grad():
        ttemb = tunet.time_embed(torch.from_numpy(t))
        th = to_channels_last(torch.from_numpy(h))
        outs = [tunet.mid_entry(th, ttemb)]
        outs.append(tunet.mid_stack_apply(outs[-1], ttemb))
        outs.append(tunet.mid_exit(outs[-1], ttemb))
    for got, want in zip(outs, (ref_entry, ref_stack, ref_exit)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def _zero_params(depth: int) -> dict:
    """Zero params of the shapes the JAX UNet's init builds at ``depth``
    (``jax.eval_shape``: nothing is compiled)."""
    cfg = _cfg(depth)
    junet = ConfigResolver(cfg).instantiate("diffusion_def")
    latent = [p // 4 for p in cfg["diffusion_train"]["patch_size"]]
    shapes = jax.eval_shape(junet.init, jax.random.PRNGKey(1),
                            jnp.zeros((1, *latent, junet.in_channels)),
                            jnp.zeros((1,), jnp.int32))["params"]
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)


def test_bridge_refuses_a_stack_of_another_depth():
    deeper = _zero_params(DEPTH + 1)
    tunet = define_instance(SimpleNamespace(**_cfg(DEPTH)), "diffusion_def")
    with pytest.raises(ValueError, match=f"unconsumed.*mid_stack/{DEPTH}/"):
        unet_state_dict_from_jax(deeper, tunet)
    shallower = dict(deeper, mid_stack=jax.tree_util.tree_map(lambda a: a[:1],
                                                              deeper["mid_stack"]))
    with pytest.raises(ValueError, match=r"unfilled.*mid_stack\.1\."):
        unet_state_dict_from_jax(shallower, tunet)


@pytest.mark.parametrize("cond_dropout,gamma", [(0.0, 0.0), (0.5, 5.0)])
def test_latents_step_matches_jax(pair, cond_dropout, gamma):
    cfg, junet, params, _ = pair
    sched_kw = dict(num_train_timesteps=16)
    state_j = JaxTrainState.create(junet.apply, params, jax_make_diffusion_optimizer(
        jax_build_lr_schedule("multistep", LR, 10, 1)))
    lat = (2, 4, 4, 4, cfg["latent_channels"])
    rng = np.random.default_rng(5)
    batch = {"label_mu": rng.standard_normal(lat), "label_sigma": rng.uniform(0.05, 0.3, lat),
             "image_mu": rng.standard_normal(lat), "image_sigma": rng.uniform(0.05, 0.3, lat)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    state_j, m_j = ref_jit(jax_latents_step(
        junet, JaxDDPM.create(**sched_kw),
        JaxStage2Config(cond_dropout=cond_dropout, min_snr_gamma=gamma)))(
        state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(SCALE), key)

    tunet = define_instance(SimpleNamespace(**cfg), "diffusion_def")
    tunet.load_state_dict(unet_state_dict_from_jax(params, tunet))
    tunet.train()
    state_t = TrainState(tunet, make_diffusion_optimizer(
        tunet.parameters(), build_lr_schedule("multistep", LR, 10, 1)))
    step = make_stage2_train_step_latents(
        tunet, PortDDPM.create(**sched_kw),
        Stage2Config(cond_dropout=cond_dropout, min_snr_gamma=gamma))
    m_t = step(state_t, {k: torch.from_numpy(v) for k, v in batch.items()}, SCALE,
               draws=_jax_draws(key, lat, 16, cond_dropout))
    np.testing.assert_allclose(float(m_t["diffusion_loss"]), float(m_j["diffusion_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]), float(m_j["grad_norm"]), rtol=1e-5)
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for n, p in tunet.named_parameters() if n.startswith("mid_stack.")
               and n.endswith("conv1.weight"))
    _assert_params_close(tunet, state_j.params)
