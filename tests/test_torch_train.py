"""Parity of the port's stage-2 training path with the JAX package.

Everything runs on the CPU in fp32; inputs and weights come from numpy with a
seed (weights through ``ldm3d_torch.ckpt.from_jax``), and every random draw
the JAX step makes inside its jit is re-derived here from its key and handed
to the port as a ``Stage2Draws``. Tolerances:

* scheduler tables 1e-6; a DDPM step and the Min-SNR weights 1e-5 (the same
  fp32 formulas, a few ulps apart where XLA reassociates them or
  1 - alpha_bar cancels);
* LR schedules: 1e-5 relative (optax evaluates in fp32, the port in fp64;
  the cosine near its 1e-6 floor keeps few digits in fp32);
* Adam updates against optax: 2e-6 on parameters of order 1 (fp32 ulps);
* one train step: loss and ``grad_norm`` within 1e-5 relative, gradients
  within 1e-4 of each leaf's largest |g| (fp32 convolutions summed in other
  orders; measured 6.2e-5 at the deepest GroupNorm's scale and bias, whose
  sums cancel), parameters after the update within 2 lr + 1e-6: Adam's
  first update is lr * g / (|g| + eps), +-lr for every element whose |g| is
  well above eps, so an element whose gradient is at rounding level may move
  by lr the other way.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import jax_models, port_models, ref_jit

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.ckpt.from_jax import state_dict_from_jax
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import define_instance, load_json
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_torch.data import LatentCache, prepare_dataloader
from ldm3d_torch.diffusion import DDPMScheduler as PortDDPM
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.training import (
    ClippedAdam,
    Stage2Config,
    Stage2Draws,
    TrainState,
    build_lr_schedule,
    clip_by_global_norm_,
    compute_scale_factor,
    make_diffusion_optimizer,
    make_stage2_eval_step,
    make_stage2_train_step_latents,
    min_snr_weights,
)
from ldm3d_tpu.diffusion import DDPMScheduler as JaxDDPM
from ldm3d_tpu.diffusion import inferer as jax_inferer
from ldm3d_tpu.training import Stage2Config as JaxStage2Config
from ldm3d_tpu.training import TrainState as JaxTrainState
from ldm3d_tpu.training import build_lr_schedule as jax_build_lr_schedule
from ldm3d_tpu.training import make_diffusion_optimizer as jax_make_diffusion_optimizer
from ldm3d_tpu.training.stage2 import min_snr_weights as jax_min_snr_weights
from ldm3d_tpu.training.stage2 import make_stage2_train_step_latents as jax_latents_step

torch.set_num_threads(1)

LR = 1e-3
SCALE = 0.9
GRAD_REL = 1e-4


# --- scheduler ---------------------------------------------------------------

@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("steps", [None, 4])
def test_ddpm_noising_and_step_match_jax(prediction_type, steps):
    kw = dict(num_train_timesteps=16, num_inference_steps=steps, prediction_type=prediction_type)
    js, ts = JaxDDPM.create(**kw), PortDDPM.create(**kw)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=1e-6)
    assert ts.timesteps == [int(t) for t in np.asarray(js.timesteps)]
    rng = np.random.default_rng(3)
    x0, noise, x, pred = (rng.standard_normal((3, 2, 2, 2, 2), dtype=np.float32)
                          for _ in range(4))
    t = np.array([0, 7, 15], np.int32)
    for name in ("add_noise", "velocity"):
        ref = getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        out = getattr(ts, name)(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    for i, step_t in enumerate(ts.timesteps):
        key = jax.random.PRNGKey(i)
        ref = js.step(jnp.asarray(pred), jnp.int32(step_t), jnp.asarray(x), key)
        z = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))
        out = ts.step_with_noise(torch.from_numpy(pred), step_t, torch.from_numpy(x),
                                 torch.from_numpy(z))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_ddpm_step_draws_from_the_generator_and_noise_coeffs_survive_bf16():
    ts = PortDDPM.create(num_train_timesteps=16)
    x, pred = torch.randn(1, 2, 2, 2, 2), torch.randn(1, 2, 2, 2, 2)
    a = ts.step(pred, 5, x, torch.Generator().manual_seed(1))
    b = ts.step(pred, 5, x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, ts.step(pred, 5, x,
                                                            torch.Generator().manual_seed(2)))
    # sqrt in fp32, only the result in bf16: abar_0 = 0.9985 would round to 1.0
    x0 = torch.zeros(1, 2, dtype=torch.bfloat16)
    noisy = ts.add_noise(x0, torch.ones(1, 2, dtype=torch.bfloat16), torch.tensor([0]))
    ref = JaxDDPM.create(num_train_timesteps=16).add_noise(
        jnp.zeros((1, 2), jnp.bfloat16), jnp.ones((1, 2), jnp.bfloat16), jnp.array([0]))
    assert float(noisy[0, 0]) > 0.03
    np.testing.assert_array_equal(noisy.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_min_snr_weights_match_jax(prediction_type):
    kw = dict(num_train_timesteps=1000, prediction_type=prediction_type)
    t = np.array([0, 1, 10, 250, 999], np.int32)
    ref = jax_min_snr_weights(JaxDDPM.create(**kw), jnp.asarray(t), 5.0)
    out = min_snr_weights(PortDDPM.create(**kw), torch.from_numpy(t), 5.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)


# --- LR schedules, clip and the optimizer ------------------------------------

@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine", "multistep"])
def test_lr_schedules_match_optax_at_boundaries(name):
    spe, max_epochs = 3, 400
    ref = jax_build_lr_schedule(name, 2e-4, max_epochs, spe)
    out = build_lr_schedule(name, 2e-4, max_epochs, spe)
    # around warmup's end (5 epochs), the multistep milestones (100, 1000
    # epochs) and the cosine horizon
    counts = [0, 1, 14, 15, 16, 299, 300, 301, 1199, 1200, 1201, 2999, 3000, 3001]
    for c in counts:
        np.testing.assert_allclose(out(c), float(ref(c)), rtol=1e-5, err_msg=f"count {c}")


def test_clip_rule_is_optax_not_clip_grad_norm():
    """Below the threshold nothing changes; above it, g * c / ||g|| exactly as
    optax, which ``torch.nn.utils.clip_grad_norm_`` (with its +1e-6) is not at
    small thresholds."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32) * 1e-3,
            "b": rng.standard_normal(5).astype(np.float32) * 1e-3}
    c = 1e-3
    ref, _ = optax.clip_by_global_norm(c).update(tree, None)
    ts = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    norm = clip_by_global_norm_(ts, c)
    assert float(norm) > c
    for t, k in zip(ts, ("a", "b")):
        np.testing.assert_allclose(t.numpy(), np.asarray(ref[k]), rtol=1e-6, atol=0)
    other = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    torch.nn.utils.clip_grad_norm_(other, c)
    assert not np.allclose(other[0].numpy(), np.asarray(ref["a"]), rtol=1e-6, atol=0)
    small = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
    clip_by_global_norm_(small, 1.0)
    assert all(torch.equal(s, torch.from_numpy(tree[k])) for s, k in zip(small, ("a", "b")))


def test_clipped_adam_matches_optax_across_lr_boundaries():
    """Three updates across two LR drops (optax counts from 0 and evaluates
    its schedule before incrementing): each update at the same learning rate
    as optax's, clip included."""
    schedule_j = jax_build_lr_schedule("multistep", 0.1, 10, 1, milestones=(1, 2))
    schedule_t = build_lr_schedule("multistep", 0.1, 10, 1, milestones=(1, 2))
    tx = jax_make_diffusion_optimizer(schedule_j)
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) * s for s in (3.0, 0.1, 2.0)]
    params_j, opt_state = {"w": jnp.asarray(p0)}, tx.init({"w": jnp.asarray(p0)})
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ClippedAdam([w], schedule_t, grad_clip=1.0)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        w.grad = torch.from_numpy(g.copy())
        opt.step(count)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params_j["w"]), rtol=0,
                                   atol=2e-6, err_msg=f"update {count}")


# --- train steps --------------------------------------------------------------

@pytest.fixture(scope="module")
def micro():
    cfg, jae, ae_params, junet, u_params = jax_models("config_micro_cpu.json", seed=4)
    return cfg, jae, ae_params, junet, u_params


def _jax_draws(rng, shape, num_train_timesteps, cond_dropout):
    """The draws of ``ldm3d_tpu.training.stage2`` (its split(rng, 5))."""
    rng_zl, rng_zi, rng_n, rng_t, rng_cd = jax.random.split(rng, 5)
    b = shape[0]
    keep = None
    if cond_dropout > 0:
        keep = np.array(jax.random.bernoulli(rng_cd, 1.0 - cond_dropout,
                                             (b,) + (1,) * (len(shape) - 1))).reshape(b)
    return Stage2Draws(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.normal(rng_zl, shape, jnp.float32), jax.random.normal(rng_zi, shape, jnp.float32),
        jax.random.normal(rng_n, shape, jnp.float32),
        jax.random.randint(rng_t, (b,), 0, num_train_timesteps))),
        None if keep is None else torch.from_numpy(keep))


def _port_state(cfg, ae_params, u_params):
    tae, tunet = port_models(cfg, ae_params, u_params)
    schedule = build_lr_schedule("multistep", LR, 10, 1)
    return tae, tunet, TrainState(tunet, make_diffusion_optimizer(tunet.parameters(), schedule))


def _assert_params_close(tunet, jax_params):
    ref = state_dict_from_jax(jax.device_get(jax_params), tunet)
    worst = max((tunet.state_dict()[k] - v).abs().max().item() for k, v in ref.items())
    assert worst <= 2 * LR + 1e-6, worst


@pytest.mark.parametrize("cond_dropout,gamma", [(0.0, 0.0), (0.5, 5.0)])
def test_latents_step_matches_jax(micro, cond_dropout, gamma):
    cfg, _, ae_params, junet, u_params = micro
    sched_kw = dict(num_train_timesteps=16)
    jcfg = JaxStage2Config(cond_dropout=cond_dropout, min_snr_gamma=gamma)
    state_j = JaxTrainState.create(junet.apply, u_params, jax_make_diffusion_optimizer(
        jax_build_lr_schedule("multistep", LR, 10, 1)))
    lat = (2, 4, 4, 4, cfg["latent_channels"])
    rng = np.random.default_rng(5)
    batch = {"label_mu": rng.standard_normal(lat), "label_sigma": rng.uniform(0.05, 0.3, lat),
             "image_mu": rng.standard_normal(lat), "image_sigma": rng.uniform(0.05, 0.3, lat)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    state_j, m_j = ref_jit(jax_latents_step(junet, JaxDDPM.create(**sched_kw), jcfg))(
        state_j, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(SCALE), key)

    _, tunet, state_t = _port_state(cfg, ae_params, u_params)
    step = make_stage2_train_step_latents(
        tunet, PortDDPM.create(**sched_kw),
        Stage2Config(cond_dropout=cond_dropout, min_snr_gamma=gamma))
    draws = _jax_draws(key, lat, 16, cond_dropout)
    m_t = step(state_t, {k: torch.from_numpy(v) for k, v in batch.items()}, SCALE, draws=draws)
    np.testing.assert_allclose(float(m_t["diffusion_loss"]), float(m_j["diffusion_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_t["grad_norm"]), float(m_j["grad_norm"]), rtol=1e-5)
    assert state_t.step == 1
    _assert_params_close(tunet, state_j.params)


def test_eval_step_and_scale_factor_match_jax_formulas(micro):
    cfg, jae, ae_params, junet, u_params = micro
    tae, tunet = port_models(cfg, ae_params, u_params)
    patch = cfg["diffusion_train"]["patch_size"]
    rng = np.random.default_rng(9)
    labels = rng.uniform(0, 1, (2, *patch, 1)).astype(np.float32)
    images = rng.uniform(0, 1, (2, *patch, 1)).astype(np.float32)
    lat = (2, *[p // 4 for p in patch], cfg["latent_channels"])
    eps = rng.standard_normal(lat).astype(np.float32)
    encode = ref_jit(lambda x: jae.apply({"params": ae_params}, x, method="encode"))
    mu, sigma = encode(jnp.asarray(labels))
    ref_sf = 1.0 / float(jnp.std(mu + sigma * jnp.asarray(eps)))
    sf = float(compute_scale_factor(tae, torch.from_numpy(labels), torch.from_numpy(eps)))
    np.testing.assert_allclose(sf, ref_sf, rtol=1e-5)

    draws = _jax_draws(jax.random.PRNGKey(2), lat, 16, 0.0)
    d = {k: jnp.asarray(v.numpy()) for k, v in vars(draws).items() if v is not None}
    sched_j = JaxDDPM.create(num_train_timesteps=16)
    z = (mu + sigma * d["eps_label"]) * jnp.float32(SCALE)
    mu_i, sigma_i = encode(jnp.asarray(images))
    model_in = jax_inferer.noise_prediction_inputs(sched_j, z, d["noise"], d["timesteps"],
                                                   mu_i + sigma_i * d["eps_image"])
    pred = ref_jit(junet.apply)({"params": u_params}, model_in, d["timesteps"])
    ref = float(jnp.mean((pred - d["noise"]) ** 2))
    eval_step = make_stage2_eval_step(tunet, tae, PortDDPM.create(num_train_timesteps=16),
                                      Stage2Config())
    out = eval_step({"image": torch.from_numpy(images), "label": torch.from_numpy(labels)},
                    SCALE, draws=draws)
    np.testing.assert_allclose(float(out["val_diffusion_loss"]), ref, rtol=1e-5)


# --- data ----------------------------------------------------------------------

@pytest.mark.parametrize("randcrop", [False, True])
def test_loaders_match_jax(randcrop):
    from ldm3d_tpu.data import prepare_dataloader as jax_prepare_dataloader

    args = SimpleNamespace(synthetic_data=True, synthetic_num=7, synthetic_shape=[20, 18, 22],
                           seed=3, val_fraction=0.3)
    jtrain, jval = jax_prepare_dataloader(args, 2, [16, 16, 16], randcrop=randcrop,
                                          num_hosts=1, host_id=0)
    ttrain, tval = prepare_dataloader(args, 2, [16, 16, 16], randcrop=randcrop)
    assert ttrain.steps_per_epoch() == jtrain.steps_per_epoch()
    for epoch in (0, 1):
        for jl, tl in ((jtrain, ttrain), (jval, tval)):
            jbs, tbs = list(jl.epoch(epoch)), list(tl.epoch(epoch))
            assert len(jbs) == len(tbs) > 0
            for jb, tb in zip(jbs, tbs):
                for k in ("image", "label"):
                    np.testing.assert_array_equal(tb[k], jb[k])


def test_latent_cache_epochs_match_jax():
    from ldm3d_tpu.data.latent_cache import LatentCache as JaxLatentCache

    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((7, 2, 2, 2, 3)).astype(np.float32) for _ in range(4)]
    jc, tc = JaxLatentCache(*arrays, batch_size=3, seed=5), LatentCache(*arrays, batch_size=3,
                                                                        seed=5)
    assert tc.steps_per_epoch() == jc.steps_per_epoch() == 2
    for epoch in (0, 1):
        for jb, tb in zip(jc.epoch(epoch), tc.epoch(epoch)):
            assert jb.keys() == tb.keys()
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])


def test_checkpoint_manager_is_atomic_and_restores(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "diffusion")
    assert mgr.try_restore("last") == (None, False)
    state = {"params": {"w": torch.arange(3.0)}, "optimizer": {"state": {}}, "step": 4}
    mgr.save_best_and_last(state, is_best=True, meta={"epoch": 2, "scale_factor": 0.5})
    restored, ok = mgr.try_restore("last")
    assert ok and restored["step"] == 4 and torch.equal(restored["params"]["w"], torch.arange(3.0))
    best = mgr.load("best")
    assert set(best) == {"state_dict", "meta"} and best["meta"]["scale_factor"] == 0.5
    assert mgr.load_meta("best") == {"epoch": 2, "scale_factor": 0.5}
    (tmp_path / "diffusion_last.pt.new").write_bytes(b"partial")   # a killed save
    CheckpointManager(str(tmp_path), "diffusion")
    assert not (tmp_path / "diffusion_last.pt.new").exists() and mgr.exists("last")
    with pytest.raises(TypeError):
        mgr.save_best_and_last({"step": 1}, is_best=True)


# --- the CLI ---------------------------------------------------------------------

def _env(tmp_path, **extra):
    env = {"model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"),
           "tfevent_path": str(tmp_path / "tb"), "seed": 1, "synthetic_data": True,
           "synthetic_num": 5, "synthetic_shape": [32, 32, 32], "resume_ckpt": False, **extra}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


def test_cli_trains_resumes_and_inference_samples_the_trained_model(tmp_path):
    cfg_path = port_preset_path("config_tiny_cpu.json")
    ae = init_weights_(define_instance(SimpleNamespace(**load_json(cfg_path)), "autoencoder_def"),
                       torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "ckpt"), "autoencoder").save(
        "best", {"state_dict": ae.state_dict()})
    argv = ["-c", cfg_path, "-e", _env(tmp_path), "--device", "cpu", "--ema-decay", "0.9",
            "--max-epochs", "1"]
    timings = {}
    best = port_train(argv, timings=timings)
    steps = len(timings["train_step_ms"])
    assert steps == 2 and np.isfinite(best) and all(np.isfinite(timings["diffusion_loss"]))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), "diffusion")
    assert all(mgr.exists(r) for r in ("best", "last", "ema"))
    assert mgr.load_meta("last")["epoch"] == 0

    # resume from 'last' (environment resume_ckpt) for a second epoch, in latent space
    argv[3] = _env(tmp_path, resume_ckpt=True)
    argv[-1] = "2"
    timings = {}
    port_train(argv + ["--cache-latents"], timings=timings)
    assert len(timings["train_step_ms"]) == 2          # only epoch 1 ran
    last = mgr.load("last")
    assert last["step"] == 2 * steps and last["meta"]["epoch"] == 1 and "ema_params" in last

    written = port_inference(["-c", cfg_path, "-e", argv[3], "--steps", "2", "--device", "cpu"])
    from ldm3d_torch.utils.nifti import read_nifti

    vol, _ = read_nifti(written[0])
    assert vol.shape == (32, 32, 32) and np.isfinite(vol).all()


def test_cli_resume_restarts_best_val_and_step_count_as_the_reference(tmp_path, monkeypatch):
    """A resume restarts best_val at inf and total_step at 0, as the JAX
    trainer does (ldm3d_tpu/cli/train_diffusion.py:242-243): with a stored
    best_val that no run can beat, the resumed epoch's validation still
    rewrites 'best', and the _iter points after the resume count from 1."""
    from test_torch_stage1 import _iter_steps, assert_reference_restarts_resume_state

    assert_reference_restarts_resume_state("train_diffusion")
    cfg_path = port_preset_path("config_micro_cpu.json")
    ae = init_weights_(define_instance(SimpleNamespace(**load_json(cfg_path)), "autoencoder_def"),
                       torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "ckpt"), "autoencoder").save(
        "best", {"state_dict": ae.state_dict()})
    argv = ["-c", cfg_path, "--device", "cpu", "--no-images", "--max-epochs"]
    timings = {}
    port_train(argv + ["1", "-e", _env(tmp_path)], timings=timings)
    steps_per_epoch = len(timings["train_step_ms"])
    mgr = CheckpointManager(str(tmp_path / "ckpt"), "diffusion")
    assert set(mgr.load_meta("last")) == {"epoch", "val_loss", "scale_factor"}
    assert mgr.load_meta("best")["epoch"] == 0
    last = mgr.load("last")
    mgr.save("last", last, {**last.pop("meta"), "best_val": -1.0})

    steps = _iter_steps(monkeypatch)
    port_train(argv + ["2", "-e", _env(tmp_path, resume_ckpt=True)])
    assert mgr.load("last")["step"] == 2 * steps_per_epoch
    assert mgr.load_meta("best")["epoch"] == 1
    assert steps == list(range(1, steps_per_epoch + 1))


@pytest.mark.parametrize("flag", [["--spatial", "2"], ["--tensor", "2"], ["--fsdp"], ["--zero"],
                                  ["--pipeline", "2"], ["--remat"], ["--grad-accum", "2"]])
def test_cli_unported_flags_name_the_roadmap(flag, tmp_path):
    """The flags whose paths are not ported raise naming their ROADMAP item;
    ``--remat``, ``--grad-accum``, ``--fsdp`` and ``--zero``, ported since
    (the last two act with more than one rank), pass the flag checks and run
    on to the stage-1 checkpoint, which this model_dir lacks; ``--spatial
    2``, ported since, needs two ranks: one process raises the JAX CLI's
    ``ValueError``."""
    argv = ["-c", port_preset_path("config_tiny_cpu.json"), "-e", _env(tmp_path),
            "--device", "cpu", *flag]
    if flag[0] in ("--remat", "--grad-accum", "--fsdp", "--zero"):
        with pytest.raises(FileNotFoundError, match="stage-1 autoencoder checkpoint"):
            port_train(argv)
    elif flag[0] == "--spatial":
        with pytest.raises(ValueError, match="does not divide 1 devices"):
            port_train(argv)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_train(argv)
