"""The port's full stage-2 step (frozen-VAE encode inside) against the JAX
package's pieces.

Split from ``tests/test_torch_train.py`` (its tolerances and helpers are
there): the JAX side's eager ``jax.value_and_grad`` through the VAE encode
and the UNet is the slowest test of that file, and takes a test process of
its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_models
from test_torch_train import GRAD_REL, LR, SCALE, _assert_params_close, _jax_draws, _port_state

from ldm3d_torch.ckpt.from_jax import state_dict_from_jax
from ldm3d_torch.diffusion import DDPMScheduler as PortDDPM
from ldm3d_torch.training import Stage2Config, make_stage2_train_step
from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
from ldm3d_tpu.diffusion import inferer as jax_inferer
from ldm3d_tpu.training import Stage2Config as JaxStage2Config
from ldm3d_tpu.training import TrainState as JaxTrainState
from ldm3d_tpu.training import build_lr_schedule as jax_build_lr_schedule
from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
from ldm3d_tpu.training.stage2 import _stage2_mse as jax_stage2_mse

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def micro():
    cfg, jae, ae_params, junet, u_params = jax_models("config_micro_cpu.json", seed=4)
    return cfg, jae, ae_params, junet, u_params


def test_full_step_with_vae_encode_matches_jax_pieces(micro):
    """The port's full step (frozen-VAE encode inside) against the JAX
    package's pieces assembled with the same posterior eps: encode, noising,
    UNet, ``_stage2_mse``, ``jax.value_and_grad`` and its optimizer."""
    cfg, jae, ae_params, junet, u_params = micro
    jcfg = JaxStage2Config(cond_dropout=0.5)
    sched_j = JaxDDPM.create(num_train_timesteps=16)
    patch = cfg["diffusion_train"]["patch_size"]
    rng = np.random.default_rng(6)
    batch = {k: rng.uniform(-0.1, 1.1, (2, *patch, 1)).astype(np.float32)
             for k in ("image", "label")}
    lat = (2, *[p // 4 for p in patch], cfg["latent_channels"])
    draws = _jax_draws(jax.random.PRNGKey(8), lat, 16, 0.5)
    d = {k: jnp.asarray(v.numpy()) for k, v in vars(draws).items()}

    def loss_fn(params):
        images, labels = (jnp.clip(jnp.asarray(batch[k]), 0.0, 1.0) for k in ("image", "label"))
        mu, sigma = jae.apply({"params": ae_params}, labels, method="encode")
        z = jax.lax.stop_gradient(mu + sigma * d["eps_label"]) * jnp.float32(SCALE)
        mu_i, sigma_i = jae.apply({"params": ae_params}, images, method="encode")
        cond = (mu_i + sigma_i * d["eps_image"]) * d["keep"].reshape(2, 1, 1, 1, 1)
        model_in = jax_inferer.noise_prediction_inputs(sched_j, z, d["noise"], d["timesteps"],
                                                       cond)
        pred = junet.apply({"params": params}, model_in, d["timesteps"])
        target = jax_inferer.training_targets(sched_j, z, d["noise"], d["timesteps"])
        return jax_stage2_mse(pred, target, d["timesteps"], sched_j, jcfg)

    # eager, as the tolerance was measured; its hundreds of small op compiles
    # go to the suite's persistent compile cache too
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        loss_j, grads_j = jax.value_and_grad(loss_fn)(u_params)
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    state_j = JaxTrainState.create(junet.apply, u_params, jax_make_diffusion_optimizer(
        jax_build_lr_schedule("multistep", LR, 10, 1))).apply_gradients(grads_j)
    clipped_j, _ = optax.clip_by_global_norm(1.0).update(grads_j, None)

    tae, tunet, state_t = _port_state(cfg, ae_params, u_params)
    step = make_stage2_train_step(tunet, tae, PortDDPM.create(num_train_timesteps=16),
                                  Stage2Config(cond_dropout=0.5))
    m = step(state_t, {k: torch.from_numpy(v) for k, v in batch.items()}, SCALE, draws=draws)
    np.testing.assert_allclose(float(m["diffusion_loss"]), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(optax.global_norm(grads_j)),
                               rtol=1e-5)
    ref_grads = state_dict_from_jax(jax.device_get(clipped_j), tunet)
    worst = {name: ((p.grad - ref_grads[name]).abs().max()
                    / ref_grads[name].abs().max().clamp_min(1e-30)).item()
             for name, p in tunet.named_parameters()}
    assert max(worst.values()) <= GRAD_REL, worst
    _assert_params_close(tunet, state_j.params)
