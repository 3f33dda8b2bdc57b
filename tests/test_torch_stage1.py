"""Parity of the port's stage-1 (VAE-GAN) training with the JAX package.

Everything runs on the CPU in fp32 on the micro preset. Weights of the
Flax trees' shapes come from numpy with a seed and reach the port through
``ldm3d_torch.ckpt.from_jax``; every random draw of the JAX step is
re-derived here from its key and handed to the port as a ``Stage1Draws``:
the posterior epsilon by applying the JAX module's own ``sampling`` to
(mu, sigma) = (0, 1) under the step's ``sample`` key (shown first to
reproduce the JAX call's reconstruction), the slice indices by
``jax.random.choice`` on the step's split keys. Tolerances:

* the optimizer against optax: 2e-6 on parameters of order 1 (fp32 ulps);
* each of three steps (a warm-up step, then two adversarial ones): every
  loss, ``g_grad_norm`` and ``d_loss`` within 1e-5 relative, and G's and D's
  parameters within 2 lr + 1e-6, the stage-2 rule (Adam's first update is
  +-lr for every element whose gradient is well above eps, so an element
  whose gradient is at rounding level may move by lr the other way);
* the eval step's four metrics within 1e-5 relative.
"""

import ast
import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_models import ref_jit

from ldm3d_torch.ckpt import (
    CheckpointManager,
    autoencoder_state_dict_from_jax,
    discriminator_state_dict_from_jax,
    lpips_state_dict_from_jax,
    state_dict_from_jax,
)
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_autoencoder import main as port_train_ae
from ldm3d_torch.cli.train_diffusion import load_frozen_autoencoder
from ldm3d_torch.cli.train_diffusion import main as port_train_diffusion
from ldm3d_torch.configs import define_instance, load_json
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_torch.nn import LPIPS as PortLPIPS
from ldm3d_torch.nn import PatchDiscriminator3D as PortDisc
from ldm3d_torch.obs import MetricsWriter
from ldm3d_torch.training import (
    Stage1Config,
    Stage1Draws,
    TrainState,
    build_lr_schedule,
    make_optimizer,
    make_stage1_eval_step,
    make_stage1_train_step,
)
from ldm3d_torch.training.stage1 import _accum_schedule
from ldm3d_tpu.configs import ConfigResolver
from ldm3d_tpu.configs import preset_path as jax_preset_path
from ldm3d_tpu.nn import LPIPS as JaxLPIPS
from ldm3d_tpu.nn import PatchDiscriminator3D as JaxDisc
from ldm3d_tpu.training import Stage1Config as JaxStage1Config
from ldm3d_tpu.training import TrainState as JaxTrainState
from ldm3d_tpu.training import build_lr_schedule as jax_build_lr_schedule
from ldm3d_tpu.training.stage1 import _accum_schedule as jax_accum_schedule
from ldm3d_tpu.training.stage1 import make_optimizer as jax_make_optimizer
from ldm3d_tpu.training.stage1 import make_stage1_eval_step as jax_eval_step
from ldm3d_tpu.training.stage1 import make_stage1_train_step as jax_train_step

torch.set_num_threads(1)

LR = 1e-4
D_CHANNELS = 8


def _fill(shapes, seed: int) -> dict:
    """Params of a Flax tree's shapes from numpy: lecun-normal kernels, small
    biases, GroupNorm scales around 1, LPIPS's ``lin_{i}`` around 1 with some
    negative entries (which ``relu`` zeroes)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = math.prod(leaf.shape[:-1])
            return (rng.standard_normal(leaf.shape) / math.sqrt(fan_in)).astype(np.float32)
        if name == "bias":
            return (0.01 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return rng.uniform(-0.2, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def lpips_params(seed: int = 0) -> dict:
    probe = jnp.zeros((1, 16, 16, 1))
    return _fill(jax.eval_shape(JaxLPIPS().init, jax.random.PRNGKey(0), probe, probe)["params"],
                 seed)


@pytest.fixture(scope="module")
def models():
    """The micro preset's Flax VAE, a 3-layer D of 8 channels and LPIPS, their
    params, and a function building the port's counterparts carrying them."""
    cfg = load_json(jax_preset_path("config_micro_cpu.json"))
    jae = ConfigResolver(cfg).instantiate("autoencoder_def")
    patch = cfg["autoencoder_train"]["patch_size"]
    key = jax.random.PRNGKey(3)
    probe = jnp.zeros((1, *patch, 1))
    g_params = _fill(jax.eval_shape(jae.init, {"params": key, "sample": key}, probe)["params"], 1)
    jdisc = JaxDisc(num_layers_d=3, channels=D_CHANNELS)
    d_params = _fill(jax.eval_shape(jdisc.init, key, probe)["params"], 2)
    l_params = lpips_params()

    def port():
        tae = define_instance(SimpleNamespace(**cfg), "autoencoder_def")
        tae.load_state_dict(autoencoder_state_dict_from_jax(g_params, tae))
        tdisc = PortDisc(num_layers_d=3, channels=D_CHANNELS)
        tdisc.load_state_dict(discriminator_state_dict_from_jax(d_params, tdisc))
        tl = PortLPIPS()
        tl.load_state_dict(lpips_state_dict_from_jax(l_params, tl))
        return tae, tdisc, tl.requires_grad_(False)

    return cfg, (jae, g_params), (jdisc, d_params), l_params, port


def _schedules():
    """warmup_cosine over 3 epochs of 1 step, warm-up 1 epoch: counts 0, 1,
    2, 3 take the warm-up start, its end, and two points of the cosine."""
    kw = dict(name="warmup_cosine", base_lr=LR, max_epochs=3, steps_per_epoch=1,
              warmup_epochs=1)
    return jax_build_lr_schedule(**kw), build_lr_schedule(**kw)


def _jax_draws(jae, g_params, key, images_shape, latent_shape, ratio=0.2):
    """The JAX step's draws from its key: (sample key, LPIPS key) = split(key);
    epsilon from the module's ``sampling`` at (0, 1); per axis, rng, sub =
    split(rng) and ``choice(sub, n, (k,), replace=False)``."""
    rng_sample, rng_p = jax.random.split(key)
    eps = jae.apply({"params": g_params}, jnp.zeros(latent_shape), jnp.ones(latent_shape),
                    method="sampling", rngs={"sample": rng_sample})
    slices = []
    for axis in range(3):
        n = images_shape[1 + axis]
        rng_p, sub = jax.random.split(rng_p)
        slices.append(np.asarray(jax.random.choice(sub, n, shape=(max(1, math.ceil(ratio * n)),),
                                                   replace=False)))
    return rng_sample, Stage1Draws(torch.from_numpy(np.array(eps)),
                                   tuple(torch.from_numpy(s.astype(np.int64)) for s in slices))


def _images(cfg, seed, batch=2):
    patch = cfg["autoencoder_train"]["patch_size"]
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.1, 1.1, (batch, *patch, 1)).astype(np.float32)


def _latent_shape(cfg, images):
    return (images.shape[0], *[s // 4 for s in images.shape[1:4]], cfg["latent_channels"])


def _assert_close_params(model, jax_params, bridge):
    ref = bridge(jax.device_get(jax_params), model)
    worst = max((model.state_dict()[k] - v).abs().max().item() for k, v in ref.items())
    assert worst <= 2 * LR + 1e-6, worst


# --- the optimizer ------------------------------------------------------------

def test_make_optimizer_matches_optax_across_schedule_boundaries():
    """Four updates across warmup_cosine's boundaries, two above the clip
    threshold: AdamW (b1 0.5, b2 0.9, weight decay 1e-5 on the un-decayed
    params) behind the global-norm clip, as optax's chain."""
    sched_j, sched_t = _schedules()
    tx = jax_make_optimizer(sched_j)
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) * s for s in (3.0, 0.1, 2.0, 0.3)]
    params_j, opt_state = {"w": jnp.asarray(p0)}, tx.init({"w": jnp.asarray(p0)})
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([w], sched_t)
    assert opt.grad_clip == 0.5 and isinstance(opt.adam, torch.optim.AdamW)
    for count, g in enumerate(grads):
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        w.grad = torch.from_numpy(g.copy())
        opt.step(count)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params_j["w"]), rtol=0,
                                   atol=2e-6, err_msg=f"update {count}")


@pytest.mark.parametrize("grad_accum", [1, 3])
def test_accum_schedule_matches_jax(grad_accum):
    sched = build_lr_schedule("warmup_cosine", 1e-3, 10, 4)
    ours = _accum_schedule(sched, grad_accum)
    ref = jax_accum_schedule(jax_build_lr_schedule("warmup_cosine", 1e-3, 10, 4), grad_accum)
    for count in (0, 1, 5, 6, 7, 13, 20, 39):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-5)
    assert _accum_schedule(0.5, grad_accum) == 0.5


def test_make_optimizer_refuses_grad_accum():
    """Since gradient accumulation is ported, ``grad_accum=2`` builds an
    accumulating optimizer (its first micro-step moves nothing), and an
    optimizer refuses a state saved under another ``grad_accum`` setting."""
    w = torch.nn.Parameter(torch.ones(2))
    opt = make_optimizer([w], lambda c: 1e-3, grad_accum=2)
    w.grad = torch.ones(2)
    opt.step(0)
    assert opt.grad_accum == 2 and opt.mini_step == 1
    torch.testing.assert_close(w.detach(), torch.ones(2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="grad-accum"):
        make_optimizer([torch.nn.Parameter(torch.ones(2))], lambda c: 1e-3).load_state_dict(
            opt.state_dict())


# --- the steps --------------------------------------------------------------------

def test_sampling_eps_reproduces_the_jax_call(models):
    """The epsilon taken from ``sampling`` at (0, 1) under a key is the
    epsilon of the module's ``__call__`` under the same key."""
    cfg, (jae, g_params), *_ = models
    images = jnp.asarray(np.clip(_images(cfg, 0), 0.0, 1.0))
    key = jax.random.PRNGKey(11)
    lat = _latent_shape(cfg, images)

    @ref_jit
    def both(params, x, k):
        recon, mu, sigma = jae.apply({"params": params}, x, rngs={"sample": k})
        eps = jae.apply({"params": params}, jnp.zeros(lat), jnp.ones(lat), method="sampling",
                        rngs={"sample": k})
        return recon, jae.apply({"params": params}, mu + sigma * eps, method="decode")

    recon, again = both(g_params, images, key)
    np.testing.assert_array_equal(np.asarray(again), np.asarray(recon))


def test_three_steps_match_jax_across_the_warmup_boundary(models):
    """A warm-up step (no D), then two adversarial steps (G against D, then
    D's update on the same reconstruction), from the same params and draws:
    after each, every metric within 1e-5 relative and both models' params
    within 2 lr + 1e-6."""
    cfg, (jae, g_params), (jdisc, d_params), l_params, port = models
    tae, tdisc, tl = port()
    jl = JaxLPIPS()

    def lpips_apply(a, b):
        return jl.apply({"params": l_params}, a, b)

    tcfg = cfg["autoencoder_train"]
    kw = dict(kl_weight=tcfg["kl_weight"], perceptual_weight=tcfg["perceptual_weight"])
    sched_j, sched_t = _schedules()
    g_j = JaxTrainState.create(jae.apply, g_params, jax_make_optimizer(sched_j))
    d_j = JaxTrainState.create(jdisc.apply, d_params, jax_make_optimizer(sched_j))
    step_j = ref_jit(jax_train_step(jae, jdisc, lpips_apply, JaxStage1Config(**kw)),
                     static_argnames=("adv_active",))
    g_t = TrainState(tae, make_optimizer(tae.parameters(), sched_t))
    d_t = TrainState(tdisc, make_optimizer(tdisc.parameters(), sched_t))
    step_t = make_stage1_train_step(tae, tdisc, tl, Stage1Config(**kw))
    for i, adv in enumerate((False, True, True)):
        images = _images(cfg, 10 + i)
        key = jax.random.PRNGKey(20 + i)
        _, draws = _jax_draws(jae, g_j.params, key, images.shape, _latent_shape(cfg, images))
        g_j, d_j, m_j = step_j(g_j, d_j, jnp.asarray(images), key, adv_active=adv)
        m_t = step_t(g_t, d_t, torch.from_numpy(images), adv, draws=draws)
        assert set(m_t) == set(m_j)
        for name in m_j:
            np.testing.assert_allclose(float(m_t[name]), float(m_j[name]), rtol=1e-5,
                                       atol=1e-12, err_msg=f"step {i} {name}")
        assert (float(m_t["adv_loss"]) > 0) == adv and (float(m_t["d_loss"]) > 0) == adv
        assert g_t.step == i + 1 and d_t.step == int(d_j.step) == i
        _assert_close_params(tae, g_j.params, autoencoder_state_dict_from_jax)
        _assert_close_params(tdisc, d_j.params, discriminator_state_dict_from_jax)


def test_eval_step_matches_jax(models):
    cfg, (jae, g_params), _, l_params, port = models
    tae, _, tl = port()
    jl = JaxLPIPS()
    kw = dict(kl_weight=1e-7, perceptual_weight=0.5)
    ref_fn = ref_jit(jax_eval_step(jae, lambda a, b: jl.apply({"params": l_params}, a, b),
                                   JaxStage1Config(**kw)))
    images = _images(cfg, 30)
    key = jax.random.PRNGKey(31)
    _, draws = _jax_draws(jae, g_params, key, images.shape, _latent_shape(cfg, images))
    ref, ref_recon = ref_fn(g_params, jnp.asarray(images), key)
    out, recon = make_stage1_eval_step(tae, tl, Stage1Config(**kw))(torch.from_numpy(images),
                                                                     draws=draws)
    assert set(out) == set(ref) and float(recon.min()) >= 0.0 and float(recon.max()) <= 1.0
    for name in ref:
        np.testing.assert_allclose(float(out[name]), float(ref[name]), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(recon.numpy(), np.asarray(ref_recon), atol=1e-4)


def test_step_draws_from_the_generator_when_no_draws_are_given(models):
    """Without draws a step draws its own from the caller's generator: the
    same seed gives the same metrics, another seed other ones."""
    cfg, *_, port = models
    tae, _, tl = port()
    images = torch.from_numpy(_images(cfg, 40))
    step = make_stage1_eval_step(tae, tl, Stage1Config(perceptual_weight=1.0))
    runs = [step(images, torch.Generator().manual_seed(s))[0]["val_recon_loss"].item()
            for s in (1, 1, 2)]
    assert runs[0] == runs[1] != runs[2]


# --- the CLI ------------------------------------------------------------------------

def _micro_preset(tmp_path, **train):
    cfg = load_json(port_preset_path("config_micro_cpu.json"))
    cfg["autoencoder_train"].update(train)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _env(tmp_path, name, **extra):
    env = {"model_dir": str(tmp_path / name / "ckpt"), "output_dir": str(tmp_path / name / "out"),
           "tfevent_path": str(tmp_path / name / "tb"), "seed": 3, "synthetic_data": True,
           "synthetic_num": 2, "synthetic_shape": [24, 24, 24], "resume_ckpt": False, **extra}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(env))
    return str(path)


def test_cli_stage1_then_stage2_then_inference(tmp_path):
    """train_autoencoder (2 epochs: a warm-up epoch, then an adversarial
    one, each validated) -> train_diffusion over the autoencoder it wrote ->
    inference, all from what stage 1 wrote; a resumed run (1 epoch, then
    resume for the second) ends with the same params as the straight one."""
    cfg = _micro_preset(tmp_path, warmup_epochs=0)
    env = _env(tmp_path, "straight")
    timings = {}
    best = port_train_ae(["-c", cfg, "-e", env, "--device", "cpu"], timings=timings)
    steps = len(timings["train_step_ms"])
    assert np.isfinite(best) and steps == 4 and timings["adv_active"] == [False, False, True, True]
    assert all(np.isfinite(timings[k]).all() for k in ("g_loss", "d_loss", "g_grad_norm"))
    assert timings["d_loss"][:2] == [0.0, 0.0] and min(timings["d_loss"][2:]) > 0
    assert len(timings["val_loss"]) == 2
    model_dir = tmp_path / "straight" / "ckpt"
    for name in ("autoencoder_best.pt", "autoencoder_last.pt", "discriminator_best.pt"):
        assert (model_dir / name).exists(), name
    last = CheckpointManager(str(model_dir), "autoencoder").load("last")
    assert last["g"]["step"] == steps and last["d"]["step"] == 2 and last["meta"]["epoch"] == 1
    args = SimpleNamespace(**load_json(cfg), model_dir=str(model_dir))
    ae = load_frozen_autoencoder(args, torch.device("cpu"), torch.float32)
    assert all(torch.isfinite(p).all() for p in ae.parameters())

    # resume: 1 epoch, then the second from 'last', equals the straight run
    env_r = _env(tmp_path, "resumed")
    port_train_ae(["-c", cfg, "-e", env_r, "--device", "cpu", "--max-epochs", "1"])
    env_r = _env(tmp_path, "resumed", resume_ckpt=True)
    timings_r = {}
    port_train_ae(["-c", cfg, "-e", env_r, "--device", "cpu"], timings=timings_r)
    assert timings_r["adv_active"] == [True, True]
    resumed = CheckpointManager(str(tmp_path / "resumed" / "ckpt"), "autoencoder").load("last")
    for part in ("g", "d"):
        for k, v in last[part]["params"].items():
            torch.testing.assert_close(resumed[part]["params"][k], v, rtol=0, atol=1e-6)

    # stage 2 over the autoencoder stage 1 wrote, then a sample
    assert np.isfinite(port_train_diffusion(["-c", cfg, "-e", env, "--device", "cpu",
                                             "--max-epochs", "1", "--no-images"]))
    written = port_inference(["-c", cfg, "-e", env, "--steps", "2", "--device", "cpu"])
    from ldm3d_torch.utils.nifti import read_nifti

    vol, _ = read_nifti(written[0])
    patch = tuple(load_json(cfg)["diffusion_train"]["patch_size"])
    assert vol.shape == patch and np.isfinite(vol).all()


def _iter_steps(monkeypatch) -> list:
    """The steps at which the CLIs write their ``*_iter`` scalars, from now on."""
    steps = []
    add_scalar = MetricsWriter.add_scalar

    def spy(self, tag, value, step):
        if tag.endswith("_iter"):
            steps.append(step)
        add_scalar(self, tag, value, step)

    monkeypatch.setattr(MetricsWriter, "add_scalar", spy)
    return steps


def assert_reference_restarts_resume_state(cli: str) -> None:
    """Reads the JAX trainer ``ldm3d_tpu/cli/<cli>.py``'s ``main`` as the
    resume tests expect it (a run of it takes minutes on the CPU): best_val
    and total_step start at inf and 0 in main's own body, on every run,
    resumed or not; they change only by min() with a validation loss and by
    += 1; and no stored "best_val" is read back (the string stands only as
    a key of the metas it writes)."""
    import ldm3d_tpu

    tree = ast.parse((Path(ldm3d_tpu.__file__).parent / "cli" / f"{cli}.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    top = {ast.unparse(n) for n in main.body}
    assert {"best_val = float('inf')", "total_step = 0"} <= top
    changes = sorted(ast.unparse(n) for n in ast.walk(main)
                     if isinstance(n, (ast.Assign, ast.AugAssign))
                     and any(isinstance(t, ast.Name) and t.id in ("best_val", "total_step")
                             for t in (n.targets if isinstance(n, ast.Assign) else [n.target])))
    assert changes == ["best_val = float('inf')", "best_val = min(best_val, val_loss)",
                       "total_step += 1", "total_step = 0"]
    keys = {id(k) for n in ast.walk(main) if isinstance(n, ast.Dict) for k in n.keys}
    assert not [n for n in ast.walk(main)
                if isinstance(n, ast.Constant) and n.value == "best_val" and id(n) not in keys]


def test_cli_resume_restarts_best_val_and_step_count_as_the_reference(tmp_path, monkeypatch):
    """A resume restarts best_val at inf and total_step at 0, as the JAX
    trainer does (ldm3d_tpu/cli/train_autoencoder.py:218-219): with a stored
    best_val that no run can beat, the resumed epoch's validation still
    rewrites 'best', the CLI returns that epoch's loss, and the first _iter
    point after the resume sits at step 1."""
    assert_reference_restarts_resume_state("train_autoencoder")
    cfg = _micro_preset(tmp_path)
    argv = ["-c", cfg, "--device", "cpu", "--no-images", "--max-epochs"]
    port_train_ae(argv + ["1", "-e", _env(tmp_path, "c7")])
    mgr = CheckpointManager(str(tmp_path / "c7" / "ckpt"), "autoencoder")
    assert set(mgr.load_meta("last")) == {"epoch", "val_loss", "best_val"}
    assert mgr.load_meta("best")["epoch"] == 0
    last = mgr.load("last")
    mgr.save("last", last, {**last.pop("meta"), "best_val": -1.0})

    steps, timings = _iter_steps(monkeypatch), {}
    best = port_train_ae(argv + ["2", "-e", _env(tmp_path, "c7", resume_ckpt=True)],
                         timings=timings)
    assert len(timings["train_step_ms"]) == 2  # only epoch 1 ran
    assert mgr.load_meta("best")["epoch"] == 1
    assert best == timings["val_loss"][-1] > 0
    assert steps and set(steps) == {1}


def test_cli_lpips_weights_load_a_port_state_dict_and_refuse_msgpack(tmp_path):
    from ldm3d_torch.cli.train_autoencoder import build_lpips

    lp = PortLPIPS()
    with torch.no_grad():
        lp.lin_0.fill_(0.25)
    torch.save(lp.state_dict(), tmp_path / "lpips.pt")
    args = SimpleNamespace(lpips_weights=str(tmp_path / "lpips.pt"))
    loaded = build_lpips(args, torch.float32, torch.device("cpu"))
    assert torch.equal(loaded.lin_0, lp.lin_0) and not loaded.lin_0.requires_grad
    (tmp_path / "lpips.msgpack").write_bytes(b"\x80")
    with pytest.raises(NotImplementedError, match="tools/jax_to_torch_ckpt.py --lpips"):
        build_lpips(SimpleNamespace(lpips_weights=str(tmp_path / "lpips.msgpack")),
                    torch.float32, torch.device("cpu"))
    with pytest.raises(FileNotFoundError, match="lpips_weights"):
        build_lpips(SimpleNamespace(lpips_weights=str(tmp_path / "missing.pt")),
                    torch.float32, torch.device("cpu"))
    default = build_lpips(SimpleNamespace(), torch.float32, torch.device("cpu"))
    again = build_lpips(SimpleNamespace(), torch.float32, torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(default.parameters(), again.parameters()))


def test_bridge_carries_every_stage1_tree(models):
    """state_dict_from_jax consumes every leaf of the three stage-1 trees."""
    _, (_, g_params), (_, d_params), l_params, port = models
    tae, tdisc, tl = port()
    for params, model in ((g_params, tae), (d_params, tdisc), (l_params, tl)):
        assert set(state_dict_from_jax(params, model)) == set(model.state_dict())
