"""Data parallelism of the port on 2 gloo ranks, against the JAX package's
2-device mesh and the port's own one-process step.

One :class:`ldm3d_torch.parallel.launch.RankPool` of 2 CPU ranks serves the
file (a module fixture; every call bounded, the ranks killed on expiry). The
steps run in fp32 on the micro preset (its UNet narrowed to two levels) on
one global batch of 2 with the global batch's draws; each rank takes its row (``tests/torch_dp_ranks.py``):

* the stage-2 step (over cached latents) against
  ``ldm3d_tpu.training.make_stage2_train_step_latents`` on a
  ``MeshSpec(data=2)`` mesh, the global batch sharded over it: loss and
  ``grad_norm`` within atol 2e-5 and rtol 2e-5 (JAX's own bar,
  ``tests/test_training.py:97-100``), the parameters within 2 lr + 1e-6 (the
  one-step rule of ``tests/test_torch_train.py``: Adam's first update is
  +-lr wherever the gradient is well above eps, so an element whose gradient
  is at rounding level may move the other way); against the port's
  one-process step: the same bars, and the applied gradients within 2e-5
  of their largest |g|;
* the stage-2 step with the VAE encode inside, its draws from a seeded
  generator (each rank draws the global batch's and keeps its row): 2 ranks
  against one process;
* the adversarial stage-1 step (G against D, then D's update) against the
  JAX step on the 2-device mesh and against one process, the same bars;
* ``GracefulShutdown.requested_global``: one rank's latch stops both ranks
  at the same step, both exit 75, and ``last`` resumes;
* a checkpoint written at world 2 (under ZeRO-1) resumes at world 1, and
  the next epoch's step equals the same resume at world 2 (under FSDP).
"""

import json
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_ranks as ranks
from test_torch_models import ref_jit
from test_torch_train import _jax_draws as stage2_jax_draws

from ldm3d_torch.ckpt import CheckpointManager, state_dict_from_jax
from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.parallel.launch import RankPool
from ldm3d_tpu.parallel import MeshSpec, create_mesh, shard_batch

torch.set_num_threads(1)

LR = 1e-4
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _no_tensorflow():
    with ranks.without_tensorflow():
        yield


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, threads=1, timeout_s=300) as p:
        yield p


@pytest.fixture(scope="module")
def mesh2():
    return create_mesh(MeshSpec(data=2), devices=jax.devices()[:2])


def nano_unet(seed: int):
    """The micro preset with a two-level UNet ([8, 8] channels, attention at
    the second level: fewer ops for XLA to compile than the micro UNet), the
    Flax UNet and its params from numpy with a seed."""
    from test_torch_stage1 import _fill

    from ldm3d_tpu.configs import ConfigResolver

    cfg = load_json(preset_path("config_micro_cpu.json"))
    cfg["diffusion_def"].update(channels=[8, 8], attention_levels=[False, True],
                                num_head_channels=[0, 8])
    junet = ConfigResolver(cfg).instantiate("diffusion_def")
    shapes = jax.eval_shape(junet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 4, 4, junet.in_channels)),
                            jnp.zeros((1,), jnp.int32))["params"]
    return cfg, junet, _fill(shapes, seed)


@pytest.fixture(scope="module")
def micro():
    """The two-level UNet (JAX and the port's weights) and the micro VAE with
    the port's seeded initialisation."""
    from ldm3d_torch.nn import init_weights_

    cfg, junet, u_params = nano_unet(4)
    ns = SimpleNamespace(**cfg)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), torch.Generator().manual_seed(4))
    ae_sd = {k: v.detach().numpy() for k, v in ae.state_dict().items()}
    u_sd = _np(state_dict_from_jax(u_params, define_instance(ns, "diffusion_def")))
    return cfg, junet, u_params, ae_sd, u_sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_metrics(got: dict, ref: dict, names):
    for name in names:
        np.testing.assert_allclose(got[name], float(ref[name]), err_msg=name, **TOL)


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def _assert_grads(a: dict, b: dict) -> None:
    """The applied gradients: max |a - b| over the largest |b| within 2e-5."""
    assert set(a) == set(b) and a
    scale = max(float(np.max(np.abs(v))) for v in b.values())
    assert _max_diff(a, b) <= 2e-5 * scale, (_max_diff(a, b), scale)


def _assert_one_process(two: dict, one: dict, params="params", grads="grads",
                        lr: float = LR) -> None:
    _assert_grads(two[grads], one[grads])
    assert _max_diff(two[params], one[params]) <= 2 * lr + 1e-6


def test_stage2_step_on_two_ranks_matches_the_jax_mesh_and_one_process(pool, mesh2, micro):
    from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
    from ldm3d_tpu.training import Stage2Config as JaxStage2Config
    from ldm3d_tpu.training import TrainState as JaxTrainState
    from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
    from ldm3d_tpu.training.stage2 import make_stage2_train_step_latents as jax_latents_step

    cfg, junet, u_params, _, u_sd = micro
    lat = (2, 4, 4, 4, cfg["latent_channels"])
    rng = np.random.default_rng(5)
    batch = {"label_mu": rng.standard_normal(lat), "label_sigma": rng.uniform(0.05, 0.3, lat),
             "image_mu": rng.standard_normal(lat), "image_sigma": rng.uniform(0.05, 0.3, lat)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    state_j = JaxTrainState.create(junet.apply, u_params,
                                   jax_make_diffusion_optimizer(lambda _: LR))
    step_j = ref_jit(jax_latents_step(junet, JaxDDPM.create(num_train_timesteps=16),
                                      JaxStage2Config()))
    with mesh2:
        state_j, m_j = step_j(state_j, shard_batch(mesh2, batch), jnp.float32(0.9), key)
    draws = tuple(None if t is None else t.numpy()
                  for t in stage2_jax_draws(key, lat, 16, 0.0).__dict__.values())

    two = pool.run(ranks.stage2_latents_step, cfg, u_sd, batch, draws, LR)
    one = ranks.stage2_latents_step(cfg, u_sd, batch, draws, LR, one_process=True)
    assert two[0]["step"] == two[1]["step"] == one["step"] == 1
    assert _max_diff(two[0]["params"], two[1]["params"]) == 0.0  # the ranks agree bit for bit
    _assert_metrics(two[0]["metrics"], m_j, ("diffusion_loss", "grad_norm"))
    _assert_metrics(two[0]["metrics"], one["metrics"], ("diffusion_loss", "grad_norm"))
    ref = _np(state_dict_from_jax(jax.device_get(state_j.params),
                                  define_instance(SimpleNamespace(**cfg), "diffusion_def")))
    assert _max_diff(two[0]["params"], ref) <= 2 * LR + 1e-6
    _assert_one_process(two[0], one)


def test_stage2_step_with_the_encode_draws_the_global_batch(pool, micro):
    """Draws from a seeded generator (none given): each rank draws the global
    batch's and keeps its row, so 2 ranks compute the one-process step."""
    cfg, *_, ae_sd, u_sd = micro
    patch = cfg["diffusion_train"]["patch_size"]
    rng = np.random.default_rng(8)
    batch = {k: rng.uniform(-0.1, 1.1, (2, *patch, 1)).astype(np.float32)
             for k in ("image", "label")}
    two = pool.run(ranks.stage2_full_step, cfg, ae_sd, u_sd, batch, LR, 3)
    one = ranks.stage2_full_step(cfg, ae_sd, u_sd, batch, LR, 3, one_process=True)
    _assert_metrics(two[0]["metrics"], one["metrics"], ("diffusion_loss", "grad_norm"))
    _assert_one_process(two[0], one)


def test_adversarial_stage1_step_on_two_ranks_matches_the_jax_mesh_and_one_process(pool, mesh2):
    from test_torch_stage1 import D_CHANNELS, _fill, _jax_draws

    from ldm3d_torch.ckpt import autoencoder_state_dict_from_jax, discriminator_state_dict_from_jax
    from ldm3d_torch.nn import PatchDiscriminator3D
    from ldm3d_tpu.configs import ConfigResolver
    from ldm3d_tpu.nn import PatchDiscriminator3D as JaxDisc
    from ldm3d_tpu.training import Stage1Config as JaxStage1Config
    from ldm3d_tpu.training import TrainState as JaxTrainState
    from ldm3d_tpu.training.stage1 import make_optimizer as jax_make_optimizer
    from ldm3d_tpu.training.stage1 import make_stage1_train_step as jax_train_step

    cfg = load_json(preset_path("config_micro_cpu.json"))
    jae = ConfigResolver(cfg).instantiate("autoencoder_def")
    patch = cfg["autoencoder_train"]["patch_size"]
    key = jax.random.PRNGKey(3)
    probe = jnp.zeros((1, *patch, 1))
    g_params = _fill(jax.eval_shape(jae.init, {"params": key, "sample": key}, probe)["params"], 1)
    jdisc = JaxDisc(num_layers_d=3, channels=D_CHANNELS)
    d_params = _fill(jax.eval_shape(jdisc.init, key, probe)["params"], 2)
    images = np.random.default_rng(12).uniform(-0.1, 1.1, (2, *patch, 1)).astype(np.float32)
    step_key = jax.random.PRNGKey(21)
    lat = (2, *[s // 4 for s in patch], cfg["latent_channels"])
    _, draws = _jax_draws(jae, g_params, step_key, images.shape, lat)
    kl = cfg["autoencoder_train"]["kl_weight"]
    g_j = JaxTrainState.create(jae.apply, g_params, jax_make_optimizer(lambda _: LR))
    d_j = JaxTrainState.create(jdisc.apply, d_params, jax_make_optimizer(lambda _: LR))
    step_j = ref_jit(jax_train_step(jae, jdisc, None, JaxStage1Config(kl_weight=kl,
                                                                      perceptual_weight=0.0)),
                     static_argnames=("adv_active",))
    with mesh2:
        g_j, d_j, m_j = step_j(g_j, d_j, shard_batch(mesh2, images), step_key, adv_active=True)

    tae = define_instance(SimpleNamespace(**cfg), "autoencoder_def")
    g_sd = _np(autoencoder_state_dict_from_jax(g_params, tae))
    tdisc = PatchDiscriminator3D(num_layers_d=3, channels=D_CHANNELS)
    d_sd = _np(discriminator_state_dict_from_jax(d_params, tdisc))
    args = (cfg, g_sd, d_sd, D_CHANNELS, images, draws.eps.numpy(), LR, True)
    two = pool.run(ranks.stage1_step, *args)
    one = ranks.stage1_step(*args, one_process=True)
    names = ("recon_loss", "kl_loss", "adv_loss", "g_loss", "g_grad_norm", "d_loss")
    assert two[0]["metrics"]["adv_loss"] > 0 and two[0]["metrics"]["d_loss"] > 0
    _assert_metrics(two[0]["metrics"], m_j, names)
    _assert_metrics(two[0]["metrics"], one["metrics"], names)
    for which, jparams, bridge, model in (
            ("g", g_j.params, autoencoder_state_dict_from_jax, tae),
            ("d", d_j.params, discriminator_state_dict_from_jax, tdisc)):
        assert _max_diff(two[0][which], two[1][which]) == 0.0
        assert _max_diff(two[0][which], _np(bridge(jax.device_get(jparams), model))) \
            <= 2 * LR + 1e-6, which
        _assert_one_process(two[0], one, which, f"{which}_grads")


def _cli_run(tmp_path, micro, name, batch, **env_extra):
    """A micro config with ``batch`` per rank and an environment whose
    4 training volumes are one global batch of 4 at world 2 (so world 1
    with batch 4 sees the same batch); the stage-1 VAE of the micro models
    as ``autoencoder_best``."""
    cfg, *_, ae_sd, _ = micro
    cfg = json.loads(json.dumps(cfg))
    cfg["diffusion_train"].update(batch_size=batch, max_epochs=1)
    cfg_path = tmp_path / f"{name}.json"
    cfg_path.write_text(json.dumps(cfg))
    model_dir = tmp_path / name / "ckpt"
    env = {"model_dir": str(model_dir), "output_dir": str(tmp_path / name / "out"),
           "tfevent_path": str(tmp_path / name / "tb"), "seed": 2, "synthetic_data": True,
           "synthetic_num": 8, "synthetic_shape": [16, 16, 16], "val_fraction": 0.5,
           "resume_ckpt": False, **env_extra}
    env_path = tmp_path / f"{name}_env.json"
    env_path.write_text(json.dumps(env))
    CheckpointManager(str(model_dir), "autoencoder").save(
        "best", {"state_dict": {k: torch.from_numpy(v) for k, v in ae_sd.items()}})
    return ["-c", str(cfg_path), "-e", str(env_path), "--device", "cpu", "--no-images"]


def _resume(argv, max_epochs):
    env = json.loads(open(argv[3]).read())
    env["resume_ckpt"] = True
    open(argv[3], "w").write(json.dumps(env))
    return argv + ["--max-epochs", str(max_epochs)]


def test_one_ranks_shutdown_stops_both_ranks_with_a_resumable_last(pool, micro, tmp_path):
    argv = _cli_run(tmp_path, micro, "stop", batch=1)  # global batch 2: two steps an epoch
    with pytest.raises(SystemExit) as exc:
        pool.run(ranks.run_cli, "train_diffusion", argv + ["--max-epochs", "2"], 1, 2)
    assert exc.value.code == 75
    last = CheckpointManager(str(tmp_path / "stop" / "ckpt"), "diffusion")
    meta = last.load_meta("last")
    assert meta["preempted"] is True and meta["epoch"] == -1 and meta["best_val"] == float("inf")
    assert last.load("last")["step"] == 1  # poll 1 ran a step on both ranks; poll 2 stopped
    out = pool.run(ranks.run_cli, "train_diffusion", _resume(argv, 1))
    assert [len(t["train_step_ms"]) for _, t in out] == [2, 2]  # epoch 0 replayed
    assert last.load("last")["step"] == 3 and last.load_meta("last")["epoch"] == 0


def test_checkpoint_of_world_two_resumes_at_world_one(pool, micro, tmp_path):
    """Epoch 0 at world 2 under ZeRO-1 writes ``last`` (the one-process
    layout); epoch 1 resumed at world 1 (per-rank batch 4: the same global
    batch) equals epoch 1 resumed at world 2 under FSDP."""
    argv2 = _cli_run(tmp_path, micro, "w2", batch=2)
    pool.run(ranks.run_cli, "train_diffusion", argv2 + ["--zero", "--ema-decay", "0.9"])
    argv1 = _cli_run(tmp_path, micro, "w1", batch=4)
    shutil.copytree(tmp_path / "w2" / "ckpt", tmp_path / "w1" / "ckpt", dirs_exist_ok=True)
    two = pool.run(ranks.run_cli, "train_diffusion",
                   _resume(argv2, 2) + ["--fsdp", "--ema-decay", "0.9"])
    one_t: dict = {}
    from ldm3d_torch.cli.train_diffusion import main as port_train

    port_train(_resume(argv1, 2) + ["--ema-decay", "0.9"], timings=one_t)
    assert len(one_t["diffusion_loss"]) == len(two[0][1]["diffusion_loss"]) == 1
    np.testing.assert_allclose(two[0][1]["diffusion_loss"], one_t["diffusion_loss"], **TOL)
    np.testing.assert_allclose(two[0][0], two[1][0])  # both ranks' validation losses agree
    a = CheckpointManager(str(tmp_path / "w2" / "ckpt"), "diffusion").load("last")
    b = CheckpointManager(str(tmp_path / "w1" / "ckpt"), "diffusion").load("last")
    assert a["step"] == b["step"] == 2
    for key in ("params", "ema_params"):
        worst = max((a[key][k] - b[key][k]).abs().max().item() for k in a[key])
        assert worst <= 2 * LR + 1e-6, key
    for i, entry in a["optimizer"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            other = b["optimizer"]["state"][i][m]
            assert entry[m].shape == other.shape
            assert (entry[m] - other).abs().max().item() <= 2e-5 * other.abs().max().item()
