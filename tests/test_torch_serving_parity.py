"""The port's server run functions against the JAX server's ``build_run``.

Both servers load ``config_tiny_cpu.json`` with the same weights: Flax init
params (the UNet's output conv made non-zero) saved as the JAX package's
orbax checkpoints, and carried into the port's ``.pt`` checkpoints by
``ldm3d_torch.ckpt.from_jax``. Each sampler variant of each server then
samples and decodes from the same numpy noise and condition latent; ddpm
takes JAX's per-step draws, rebuilt from the run's key as JAX's
``sample_latents`` splits it. fp32 on the CPU; tolerance 1e-4 on the decoded
volumes, the whole-sample tolerance of ROADMAP.md. (Served volumes cannot
match across frameworks for one seed: their generators draw differently.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scaffolds import write_env_json
from test_torch_models import jax_models, port_models, ref_jit

from ldm3d_torch.cli.common import save_two_stage
from ldm3d_torch.serving.model_server import ModelServer as PortServer
from ldm3d_tpu.serving.model_server import ModelServer as JaxServer

torch.set_num_threads(1)

ATOL = 1e-4
SCALE_FACTOR = 0.8


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from ldm3d_tpu.ckpt import CheckpointManager, StageArtifacts
    from ldm3d_tpu.configs import preset_path

    root = tmp_path_factory.mktemp("serving_parity")
    cfg, _, ae_params, _, u_params = jax_models("config_tiny_cpu.json", seed=4)
    model_dir = root / "ckpts"
    CheckpointManager(str(model_dir), StageArtifacts.AUTOENCODER).save(
        "best", {"params": ae_params}, meta={})
    CheckpointManager(str(model_dir), StageArtifacts.DIFFUSION).save(
        "best", {"params": u_params}, meta={"scale_factor": SCALE_FACTOR})
    tae, tunet = port_models(cfg, ae_params, u_params)
    save_two_stage(str(model_dir), tae, tunet, SCALE_FACTOR)  # the port's files beside
    env = write_env_json(root / "env.json", model_dir, root)
    cfg_path = preset_path("config_tiny_cpu.json")
    jsrv = JaxServer(cfg_path, env, sampler="ddim", steps=2)
    psrv = PortServer(cfg_path, env, sampler="ddim", steps=2, device="cpu")
    for srv in (jsrv, psrv):
        srv.load_model()
        assert not srv.is_dummy
    return jsrv, psrv


@pytest.mark.parametrize("sampler,steps,guidance", [("ddim", 2, 1.0), ("dpm", 4, 2.0),
                                                    ("ddpm", 3, 1.0)])
def test_run_functions_match_jax(servers, sampler, steps, guidance):
    jsrv, psrv = servers
    rng = np.random.default_rng(steps)
    noise = rng.standard_normal((1, *psrv._latent_shape)).astype(np.float32)
    cond = rng.standard_normal((1, *psrv._cond_shape)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = np.concatenate([np.asarray(v) for v in ref_jit(jsrv._build_run(
        sampler, steps, guidance))(jnp.asarray(noise), key, jnp.asarray(cond))])
    draws = None
    if sampler == "ddpm":
        draws = [torch.from_numpy(np.array(jax.random.normal(k, noise.shape, jnp.float32)))
                 for k in jax.random.split(key, steps)]
    run = psrv._build_run(sampler, steps, guidance)
    out = np.concatenate([v.numpy() for v in run(torch.from_numpy(noise), None,
                                                 torch.from_numpy(cond), step_noises=draws)])
    assert out.shape == ref.shape == (1, *psrv.patch_size, 1) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
