"""Parity of the port's samplers with the JAX package.

Every sampler (ddpm full and strided, ddim at eta 0 and eta > 0, GridDDIM
through karras, dpm, dpm3) on every spacing it takes, run by each package's
``sample_latents`` with the same analytic ``unet_apply`` and the same numpy
noise. The steps that add noise (ddpm, ddim with eta > 0) get JAX's own
per-step draws, rebuilt here as ``sample_latents`` and ``step`` make them:
one key per step from ``jax.random.split``, then ``jax.random.normal``.
fp32 on the CPU, atol 1e-5: the same fp32 arithmetic in another order.

Also the scheduler tables, the grids and their errors, and the inference
CLI's sampler options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d_torch.cli import common as port_common
from ldm3d_torch.diffusion import DDIMScheduler as PortDDIM
from ldm3d_torch.diffusion import DDPMScheduler as PortDDPM
from ldm3d_torch.diffusion import GridDDIMScheduler as PortGrid
from ldm3d_torch.diffusion import distillation_grid as port_distillation_grid
from ldm3d_torch.diffusion import inferer as port_inferer
from ldm3d_torch.diffusion import karras_timestep_grid as port_karras
from ldm3d_tpu.cli import common as jax_common
from ldm3d_tpu.diffusion import DDIMScheduler as JaxDDIM
from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
from ldm3d_tpu.diffusion import GridDDIMScheduler as JaxGrid
from ldm3d_tpu.diffusion import distillation_grid as jax_distillation_grid
from ldm3d_tpu.diffusion import inferer as jax_inferer
from ldm3d_tpu.diffusion import karras_timestep_grid as jax_karras

torch.set_num_threads(1)

ATOL = 1e-5
N_TRAIN = 16
SCHED_CFG = {"num_train_timesteps": N_TRAIN, "schedule": "scaled_linear_beta",
             "beta_start": 0.0015, "beta_end": 0.0195, "prediction_type": "epsilon"}
SHAPE = (2, 3, 3, 3, 2)

# (sampler, steps, eta): eta is None for the samplers make_sampling_scheduler
# builds, a float for DDIMScheduler.create (the JAX CLI has no eta option)
SAMPLERS = [("ddpm", None, None), ("ddpm", 4, None), ("ddim", 4, None), ("ddim", 4, 0.7),
            ("dpm", 6, None), ("dpm3", 6, None)]
CASES = [(s, n, eta, spacing) for s, n, eta in SAMPLERS
         for spacing in ("leading", "trailing", "karras")
         if not (spacing == "karras" and (s == "ddpm" or eta is not None))]


def _unet(lib):
    """A fixed analytic eps-model, the same in both frameworks."""
    def apply(x, t):
        tt = t.reshape(-1, 1, 1, 1, 1) / N_TRAIN
        return 0.6 * lib.tanh(x) * (1.0 + tt) + 0.1 * lib.sin(3.0 * x) - 0.05 * tt
    return apply


def _schedulers(sampler, steps, eta, spacing):
    if eta is not None:
        kw = dict(SCHED_CFG, num_inference_steps=steps, eta=eta, timestep_spacing=spacing)
        return JaxDDIM.create(**kw), PortDDIM.create(**kw)
    return (jax_common.make_sampling_scheduler(sampler, steps, SCHED_CFG, spacing),
            port_common.make_sampling_scheduler(sampler, steps, SCHED_CFG, spacing))


def _jax_step_noises(key, n_steps):
    return [np.array(jax.random.normal(k, SHAPE, jnp.float32))
            for k in jax.random.split(key, n_steps)]


@pytest.mark.parametrize("sampler,steps,eta,spacing", CASES)
def test_sample_latents_matches_jax(sampler, steps, eta, spacing):
    js, ts = _schedulers(sampler, steps, eta, spacing)
    assert [int(t) for t in np.asarray(js.timesteps)] == list(ts.timesteps)
    noise = np.random.default_rng(11).standard_normal(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_inferer.sample_latents(_unet(jnp), js, jnp.asarray(noise), key))
    draws = None
    if sampler == "ddpm" or eta is not None:
        draws = [torch.from_numpy(z) for z in _jax_step_noises(key, len(ts.timesteps))]
    out = port_inferer.sample_latents(_unet(torch), ts, torch.from_numpy(noise),
                                      step_noises=draws).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_noisy_steps_draw_from_the_generator():
    """ddpm and ddim with eta > 0 draw per step from the caller's generator:
    the same seed gives the same sample, another seed another one; ddim at
    eta 0 draws nothing."""
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32))
    for sched in (port_common.make_sampling_scheduler("ddpm", 4, SCHED_CFG),
                  PortDDIM.create(**SCHED_CFG, num_inference_steps=4, eta=0.5)):
        runs = [port_inferer.sample_latents(_unet(torch), sched, noise,
                                            generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    port_inferer.sample_latents(_unet(torch), PortDDIM.create(**SCHED_CFG, num_inference_steps=4),
                                noise, generator=gen)
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="step noises"):
        port_inferer.sample_latents(_unet(torch), PortDDIM.create(**SCHED_CFG,
                                                                  num_inference_steps=4),
                                    noise, step_noises=[noise])


@pytest.mark.parametrize("steps,spacing", [(8, "leading"), (4, "trailing"), (16, "leading")])
def test_strided_ddpm_tables_and_step_match_jax(steps, spacing):
    kw = dict(num_train_timesteps=N_TRAIN, num_inference_steps=steps, timestep_spacing=spacing)
    js, ts = JaxDDPM.create(**kw), PortDDPM.create(**kw)
    assert [int(t) for t in np.asarray(js.timesteps)] == ts.timesteps
    rng = np.random.default_rng(steps)
    x, pred = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    for i, t in enumerate(ts.timesteps):
        key = jax.random.PRNGKey(i)
        z = np.array(jax.random.normal(key, SHAPE, jnp.float32))
        ref = np.asarray(js.step(jnp.asarray(pred), jnp.int32(t), jnp.asarray(x), key))
        out = ts.step_with_noise(torch.from_numpy(pred), t, torch.from_numpy(x),
                                 torch.from_numpy(z)).numpy()
        # the beta tables may differ in their last fp32 bit between the two
        # linspaces, and the step divides by 1 - abar_t (= beta_0 at t = 0)
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_scheduler_rules_match_jax():
    """The step-count, spacing and karras rules raise in both packages alike."""
    bad = [
        lambda m: m.DDPMScheduler.create(num_train_timesteps=16, num_inference_steps=17),
        lambda m: m.DDPMScheduler.create(num_train_timesteps=16, num_inference_steps=0),
        lambda m: m.DDIMScheduler.create(num_train_timesteps=16, num_inference_steps=17),
        lambda m: m.DDIMScheduler.create(num_train_timesteps=16, num_inference_steps=0),
        lambda m: m.DDIMScheduler.create(num_train_timesteps=16, num_inference_steps=6,
                                         timestep_spacing="trailing"),
        lambda m: m.DDPMScheduler.create(num_train_timesteps=16, num_inference_steps=6,
                                         timestep_spacing="trailing"),
        lambda m: m.DDIMScheduler.create(timestep_spacing="karras"),
        lambda m: m.DPMSolverPPScheduler.create(num_train_timesteps=16, num_inference_steps=4,
                                                solver_order=4),
    ]
    import ldm3d_torch.diffusion as port_diffusion
    import ldm3d_tpu.diffusion as jax_diffusion

    for make in bad:
        msgs = []
        for mod in (jax_diffusion, port_diffusion):
            with pytest.raises(ValueError) as info:
                make(mod)
            msgs.append(str(info.value).split(":")[0])
        assert msgs[0][:30] == msgs[1][:30]
    for common in (jax_common, port_common):
        with pytest.raises(ValueError, match="karras.*ddpm"):
            common.make_sampling_scheduler("ddpm", 4, SCHED_CFG, "karras")
        with pytest.raises(ValueError, match="trailing"):
            common.make_sampling_scheduler("ddim", 6, SCHED_CFG, "trailing")
        with pytest.raises(ValueError, match="unknown sampler"):
            common.make_sampling_scheduler("plms", 4, SCHED_CFG)
        assert common.default_sampler_steps("ddpm", SCHED_CFG) == 16
        assert common.default_sampler_steps("dpm", {"num_train_timesteps": 1000}) == 50
    # dpm/dpm3 on a trailing grid take any step count
    port_common.make_sampling_scheduler("dpm", 6, SCHED_CFG, "trailing")


@pytest.mark.parametrize("n_train,n", [(16, 6), (16, 8), (1000, 50)])
def test_grids_match_jax(n_train, n):
    np.testing.assert_array_equal(port_karras(n_train, n), jax_karras(n_train, n))
    np.testing.assert_array_equal(port_distillation_grid(n_train, n),
                                  jax_distillation_grid(n_train, n))
    grid = jax_distillation_grid(n_train, n)[:-1]
    js, ts = JaxGrid.create(grid, num_train_timesteps=n_train), PortGrid.create(
        grid, num_train_timesteps=n_train)
    np.testing.assert_allclose(ts.next_abar.numpy(), np.asarray(js.next_abar), rtol=1e-6)
    assert ts.timesteps == [int(t) for t in grid] and ts.num_inference_steps == n


def test_grid_errors_match_jax():
    for fn in (port_karras, jax_karras):
        with pytest.raises(ValueError, match="same timestep"):
            fn(16, 10)
        with pytest.raises(ValueError, match="2 <= steps"):
            fn(16, 1)
    for fn in (port_distillation_grid, jax_distillation_grid):
        with pytest.raises(ValueError, match="grid steps"):
            fn(16, 17)
    for cls in (PortGrid, JaxGrid):
        with pytest.raises(ValueError, match="descending"):
            cls.create([3, 5], num_train_timesteps=16)
        with pytest.raises(ValueError, match="out of range"):
            cls.create([16, 5], num_train_timesteps=16)
