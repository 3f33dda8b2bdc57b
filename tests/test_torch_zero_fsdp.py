"""ZeRO-1 and FSDP of the port on 2 gloo ranks against the JAX package's
``shard_train_state_zero`` / ``shard_train_state_fsdp`` on a 2-device mesh.

One stage-2 step (over cached latents, an EMA kept) in fp32 on a two-level
UNet narrowed from the micro preset (``tests/test_torch_ddp.py``
``nano_unet``), one global batch of 2 with the global batch's draws, from
the same weights: the JAX state sharded by ``ldm3d_tpu.parallel`` and the step run
under the mesh; the port's ranks each on their row with
``ldm3d_torch.parallel.zero.shard_train_state_zero`` or
``ldm3d_torch.parallel.fsdp.shard_train_state_fsdp``. Held: the loss and
``grad_norm`` within atol 2e-5 and rtol 2e-5 (JAX's bar); the step's
update (params less the start) within UPDATE_TOL of JAX's, and the EMA's
within EMA_TOL, on every element whose gradient is at least G_MIN (far
above Adam's eps 1e-8, where Adam's first update is -lr sign(g)): a ZeRO-1
whose ranks never put their slices back together leaves elements off by
about lr = 100 UPDATE_TOL, and an EMA that never updates is off by about
(1 - decay) lr = 20 EMA_TOL; the params and the EMA bit-equal on both
ranks; Adam's moments, gathered into the one-process layout, within 2e-5
of their largest value; each rank holding only its share of the moments
(and, under FSDP, of the parameters). The placement rule itself is held to
JAX's in ``tests/test_torch_parallel.py``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dp_ranks as ranks
from test_torch_ddp import nano_unet
from test_torch_models import ref_jit
from test_torch_train import _jax_draws as stage2_jax_draws

from ldm3d_torch.ckpt import state_dict_from_jax
from ldm3d_torch.configs import define_instance
from ldm3d_torch.parallel.launch import RankPool
from ldm3d_tpu.parallel import (
    MeshSpec,
    create_mesh,
    shard_batch,
    shard_train_state_fsdp,
    shard_train_state_zero,
)

torch.set_num_threads(1)

LR = 1e-4
EMA = 0.9
TOL = dict(atol=2e-5, rtol=2e-5)
UPDATE_TOL, EMA_TOL, G_MIN = 1e-6, 5e-7, 1e-5


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, threads=1, timeout_s=300) as p:
        yield p


@pytest.fixture(scope="module")
def case():
    """The two-level UNet, a latent batch and its draws."""
    cfg, junet, u_params = nano_unet(4)
    tunet = define_instance(SimpleNamespace(**cfg), "diffusion_def")
    u_sd = {k: v.numpy() for k, v in state_dict_from_jax(u_params, tunet).items()}
    lat = (2, 4, 4, 4, cfg["latent_channels"])
    rng = np.random.default_rng(6)
    batch = {"label_mu": rng.standard_normal(lat), "label_sigma": rng.uniform(0.05, 0.3, lat),
             "image_mu": rng.standard_normal(lat), "image_sigma": rng.uniform(0.05, 0.3, lat)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)
    draws = tuple(None if t is None else t.numpy()
                  for t in stage2_jax_draws(key, lat, 16, 0.0).__dict__.values())
    return cfg, junet, u_params, tunet, u_sd, batch, key, draws


def _jax_step(junet, u_params, batch, key, shard):
    from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
    from ldm3d_tpu.training import Stage2Config as JaxStage2Config
    from ldm3d_tpu.training import TrainState as JaxTrainState
    from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
    from ldm3d_tpu.training.stage2 import make_stage2_train_step_latents as jax_latents_step

    mesh = create_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    state = JaxTrainState.create(junet.apply, u_params, jax_make_diffusion_optimizer(lambda _: LR),
                                 ema_decay=EMA)
    with mesh:
        state = shard(state, mesh)
        step = ref_jit(jax_latents_step(junet, JaxDDPM.create(num_train_timesteps=16),
                                        JaxStage2Config()))
        state, metrics = step(state, shard_batch(mesh, batch), jnp.float32(0.9), key)
    return state, metrics


def _jax_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return jax.device_get(adam[0].mu), jax.device_get(adam[0].nu)


@pytest.mark.parametrize("mode,shard", [("zero", shard_train_state_zero),
                                        ("fsdp", shard_train_state_fsdp)])
def test_two_ranks_match_the_jax_sharded_state(pool, case, mode, shard):
    cfg, junet, u_params, tunet, u_sd, batch, key, draws = case
    state_j, m_j = _jax_step(junet, u_params, batch, key, shard)
    out = pool.run(ranks.stage2_latents_step, cfg, u_sd, batch, draws, LR, mode, ema_decay=EMA)
    got = out[0]
    for name in ("diffusion_loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][name], float(m_j[name]), err_msg=name, **TOL)

    def ref(tree):
        return {k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(tree), tunet).items()}

    grads = got["grads"]
    assert sum(int(np.sum(np.abs(g) >= G_MIN)) for g in grads.values()) > 0.9 * sum(
        g.size for g in grads.values())
    for name, tree, tol in (("params", state_j.params, UPDATE_TOL),
                            ("ema", state_j.ema_params, EMA_TOL)):
        want = ref(tree)
        assert set(got[name]) == set(want) == set(u_sd) == set(grads), name
        for k, v in want.items():
            held = np.abs(grads[k]) >= G_MIN
            diff = np.abs((got[name][k] - u_sd[k]) - (v - u_sd[k]))[held]
            assert diff.size == 0 or float(diff.max()) <= tol, (name, k, float(diff.max()))
            # every rank holds the same whole tensors after the step
            assert np.array_equal(out[1][name][k], got[name][k]), (name, k)
    names = [n for n, _ in tunet.named_parameters()]
    for key_, tree in zip(("exp_avg", "exp_avg_sq"), _jax_moments(state_j.opt_state)):
        want = ref(tree)
        top = max(float(np.max(np.abs(v))) for v in want.values())
        for i, name in enumerate(names):
            mine = got["optimizer"]["state"][i][key_].numpy()
            assert mine.shape == want[name].shape
            assert float(np.max(np.abs(mine - want[name]))) <= 2e-5 * top, (key_, name)
    # each rank holds its share only; together they hold every element
    total = sum(int(np.prod(v.shape)) for v in u_sd.values())
    for rank_out in out:
        assert rank_out["moment_elems"] < 0.75 * total
        if mode == "fsdp":
            assert rank_out["param_elems"] < 0.75 * total
    assert sum(r["moment_elems"] for r in out) >= total
    assert out[0]["step"] == out[1]["step"] == 1
