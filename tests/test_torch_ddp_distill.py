"""One progressive-distillation step of the port on 2 gloo ranks, against
the JAX package's step on a 2-device mesh and the port's one-process step.

The micro preset's VAE and a two-level UNet (``tests/test_torch_ddp.py``
``nano_unet``), weights from numpy with a seed, fp32, one global batch of 2
with the JAX step's draws (``tests/test_torch_distill_step.py``
``_jax_draws``), each rank on its row. Held: ``distill_loss`` and
``grad_norm`` within atol 2e-5 and rtol 2e-5 (JAX's bar), the student's
parameters within 2 lr + 1e-6 (the one-step rule), and against one process
the applied gradients within 2e-5 of their largest |g|.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_ranks as ranks
from test_torch_ddp import _assert_one_process, _max_diff, nano_unet
from test_torch_distill import N_TRAIN, SCALE
from test_torch_distill_step import _jax_draws
from test_torch_models import ref_jit

from ldm3d_torch.ckpt import autoencoder_state_dict_from_jax, state_dict_from_jax
from ldm3d_torch.configs import define_instance
from ldm3d_torch.parallel.launch import RankPool
from ldm3d_tpu.parallel import MeshSpec, create_mesh, shard_batch

torch.set_num_threads(1)

LR = 1e-3
TOL = dict(atol=2e-5, rtol=2e-5)
TEACHER_STEPS = 4


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, threads=1, timeout_s=300) as p:
        yield p


def test_distillation_step_on_two_ranks_matches_the_jax_mesh_and_one_process(pool):
    from test_torch_stage1 import _fill

    from ldm3d_tpu.configs import ConfigResolver
    from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
    from ldm3d_tpu.training import DistillConfig as JaxDistillConfig
    from ldm3d_tpu.training import TrainState as JaxTrainState
    from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
    from ldm3d_tpu.training import make_distillation_step as jax_make_distillation_step

    cfg, junet, u_params = nano_unet(5)
    jae = ConfigResolver(cfg).instantiate("autoencoder_def")
    patch = cfg["diffusion_train"]["patch_size"]
    key = jax.random.PRNGKey(0)
    ae_params = _fill(jax.eval_shape(jae.init, {"params": key, "sample": key},
                                     jnp.zeros((1, *patch, 1)))["params"], 6)
    rng = np.random.default_rng(11)
    batch = {k: rng.uniform(-0.1, 1.1, (2, *patch, 1)).astype(np.float32)
             for k in ("image", "label")}
    step_key = jax.random.PRNGKey(3)
    mesh = create_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    jstep = ref_jit(jax_make_distillation_step(
        junet, jae, JaxDDPM.create(num_train_timesteps=N_TRAIN),
        JaxDistillConfig(teacher_steps=TEACHER_STEPS)))
    jstate = JaxTrainState.create(junet.apply, jax.tree_util.tree_map(jnp.array, u_params),
                                  jax_make_diffusion_optimizer(lambda _: LR))
    with mesh:
        jstate, jm = jstep(jstate, u_params, ae_params, shard_batch(mesh, batch),
                           jnp.float32(SCALE), step_key)

    ns = SimpleNamespace(**cfg)
    tae, tunet = define_instance(ns, "autoencoder_def"), define_instance(ns, "diffusion_def")
    ae_sd = {k: v.numpy() for k, v in autoencoder_state_dict_from_jax(ae_params, tae).items()}
    u_sd = {k: v.numpy() for k, v in state_dict_from_jax(u_params, tunet).items()}
    latent = (2, *[p // tae.downsample_factor for p in patch], cfg["latent_channels"])
    draws = _jax_draws(jae, ae_params, step_key, latent, TEACHER_STEPS // 2, True)
    draws = tuple(t.numpy() for t in draws.__dict__.values())
    args = (cfg, ae_sd, u_sd, batch, draws, LR, N_TRAIN, TEACHER_STEPS, SCALE)
    two = pool.run(ranks.distill_step, *args)
    one = ranks.distill_step(*args, one_process=True)
    for name in ("distill_loss", "grad_norm"):
        np.testing.assert_allclose(two[0]["metrics"][name], float(jm[name]), err_msg=name, **TOL)
        np.testing.assert_allclose(two[0]["metrics"][name], one["metrics"][name], err_msg=name,
                                   **TOL)
    assert _max_diff(two[0]["params"], two[1]["params"]) == 0.0
    ref = {k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(jstate.params),
                                                         tunet).items()}
    assert _max_diff(two[0]["params"], ref) <= 2 * LR + 1e-6
    _assert_one_process(two[0], one, lr=LR)
