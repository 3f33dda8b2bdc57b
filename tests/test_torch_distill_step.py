"""One progressive-distillation step of the port against the JAX step.

Split from ``tests/test_torch_distill.py`` (its constants are there): one
distillation step (``make_distillation_step``) against
``ldm3d_tpu.training.make_distillation_step`` on the ``config_micro_cpu``
models in four configurations, its posterior eps rebuilt from the Flax
VAE's ``make_rng("sample")`` of each split key: the loss and ``grad_norm``
within 1e-5 relative, the student's parameters within 2 lr + 1e-6. Each
configuration traces its own JAX step, so these four take a test process of
their own.
"""

import copy
import functools

import numpy as np
import pytest
import torch
from test_torch_distill import LR, N_TRAIN, SCALE

from ldm3d_torch.configs import load_json, preset_path
from ldm3d_torch.diffusion import DDPMScheduler
from ldm3d_torch.training import (
    DistillConfig,
    DistillDraws,
    TrainState,
    make_diffusion_optimizer,
    make_distillation_step,
)

torch.set_num_threads(1)


# --- one step against the JAX step ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _micro(conditional: bool):
    """The micro preset's Flax VAE and UNet with initialised params (the
    UNet's zero-init output conv drawn), the UNet unconditional when asked,
    and the port's models carrying the same weights; built once a process
    (callers copy the port's UNet before training it)."""
    import jax
    import jax.numpy as jnp
    from test_torch_models import jax_models, port_models, ref_jit

    from ldm3d_tpu.configs import ConfigResolver

    if conditional:  # the micro models of tests/test_torch_train.py (seed 4)
        cfg, jae, ae_params, junet, u_params = jax_models("config_micro_cpu.json", seed=4)
        tae, tunet = port_models(cfg, ae_params, u_params)
        return cfg, jae, ae_params, junet, u_params, tae, tunet
    cfg = copy.deepcopy(load_json(preset_path("config_micro_cpu.json")))
    cfg["diffusion_def"]["in_channels"] = cfg["latent_channels"]
    r = ConfigResolver(cfg)
    jae, junet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    patch = cfg["diffusion_train"]["patch_size"]
    latent = [p // jae.downsample_factor for p in patch]
    key = jax.random.PRNGKey(4)
    ae_params = jax.device_get(ref_jit(jae.init)({"params": key, "sample": key},
                                                 jnp.zeros((1, *patch, 1)))["params"])
    u_params = jax.device_get(ref_jit(junet.init)(key, jnp.zeros((1, *latent, junet.in_channels)),
                                                  jnp.zeros((1,), jnp.int32))["params"])
    kernel = u_params["conv_out"]["kernel"]
    u_params["conv_out"]["kernel"] = 0.05 * np.random.default_rng(4).standard_normal(
        kernel.shape).astype(np.float32)
    tae, tunet = port_models(cfg, ae_params, u_params)
    return cfg, jae, ae_params, junet, u_params, tae, tunet


def _jax_draws(jae, ae_params, key, latent_shape, m, conditional) -> DistillDraws:
    """The draws of ``ldm3d_tpu.training.distill``'s step (its split(rng, 4)):
    each posterior epsilon from the key the Flax VAE's ``make_rng("sample")``
    derives from its split key, the noise, and j."""
    import jax
    import jax.numpy as jnp

    rng_zl, rng_zi, rng_n, rng_j = jax.random.split(key, 4)

    def posterior_eps(k):
        sample_key = jae.apply({"params": ae_params}, method=lambda mod: mod.make_rng("sample"),
                               rngs={"sample": k})
        return jax.random.normal(sample_key, latent_shape, jnp.float32)

    arrays = (posterior_eps(rng_zl), posterior_eps(rng_zi) if conditional else None,
              jax.random.normal(rng_n, latent_shape, jnp.float32),
              jax.random.randint(rng_j, (latent_shape[0],), 0, m))
    return DistillDraws(*(None if a is None else torch.from_numpy(np.array(a)) for a in arrays))


STEP_CASES = {"eps_to_eps": dict(student_prediction_type=None),
              "eps_to_v": dict(student_prediction_type="v_prediction"),
              "guided_2": dict(guidance_scale=2.0),
              "unconditional": dict(conditional=False)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_distillation_step_matches_jax(case):
    import jax
    import jax.numpy as jnp
    from test_torch_models import ref_jit

    from ldm3d_torch.ckpt.from_jax import state_dict_from_jax
    from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
    from ldm3d_tpu.training import DistillConfig as JaxDistillConfig
    from ldm3d_tpu.training import TrainState as JaxTrainState
    from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
    from ldm3d_tpu.training import make_distillation_step as jax_make_distillation_step

    kw = dict(teacher_steps=4, **STEP_CASES[case])
    conditional = kw.get("conditional", True)
    cfg, jae, ae_params, junet, u_params, tae, tunet = _micro(conditional)
    patch = cfg["diffusion_train"]["patch_size"]
    rng = np.random.default_rng(11)
    batch = {k: rng.uniform(-0.1, 1.1, (2, *patch, 1)).astype(np.float32)
             for k in ("image", "label")}
    key = jax.random.PRNGKey(3)

    jstep = ref_jit(jax_make_distillation_step(
        junet, jae, JaxDDPM.create(num_train_timesteps=N_TRAIN), JaxDistillConfig(**kw)))
    jstate = JaxTrainState.create(junet.apply, jax.tree_util.tree_map(jnp.array, u_params),
                                  jax_make_diffusion_optimizer(lambda _: LR))
    jstate, jm = jstep(jstate, u_params, ae_params, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.float32(SCALE), key)

    latent = (2, *[p // tae.downsample_factor for p in patch], cfg["latent_channels"])
    draws = _jax_draws(jae, ae_params, key, latent, kw["teacher_steps"] // 2, conditional)
    teacher = tunet.requires_grad_(False)
    student = copy.deepcopy(teacher).requires_grad_(True).train()
    state = TrainState(student, make_diffusion_optimizer(student.parameters(), lambda _: LR))
    step = make_distillation_step(teacher, tae, DDPMScheduler.create(num_train_timesteps=N_TRAIN),
                                  DistillConfig(**kw))
    m = step(state, teacher, {k: torch.from_numpy(v) for k, v in batch.items()}, SCALE,
             draws=draws)
    np.testing.assert_allclose(float(m["distill_loss"]), float(jm["distill_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == 1
    assert all(p.grad is None for p in teacher.parameters())
    ref = state_dict_from_jax(jax.device_get(jstate.params), student)
    worst = max((student.state_dict()[k] - v).abs().max().item() for k, v in ref.items())
    assert worst <= 2 * LR + 1e-6, worst
