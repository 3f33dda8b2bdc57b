"""``--fused-decode``: the captured sampler against the eager loop and the JAX package.

``ldm3d_torch.diffusion.inferer.CapturedSampler`` runs one step of the
reverse loop from the scheduler's step table (its timestep and
coefficients read at a device step index) and, on the card, captures that
step and the decode as CUDA graphs. On the CPU the same step body runs
eagerly; it is the plain version these tests hold:

* the table-driven loop gives the eager ``sample_latents``'s bits (torch.equal)
  for every sampler, spacing, eta and prediction type, with and without
  guidance, fp32 and bf16;
* ``cli.inference --fused-decode --device cpu`` against the JAX pipeline
  (encode, loop, ``/ scale_factor``, decode: the arithmetic of the JAX
  CLI's ``fused_fn``) within ``ATOL_SAMPLE`` of ``test_torch_sample.py``
  (1e-4), for ddim and dpm3 with and without guidance at batch 1 and 2, and
  the captured sampler's ddpm, fed JAX's own per-step draws;
* the CLI with ``-n 2 --decode-chunk 1 --fused-decode`` writes the eager
  CLI's volumes, bit for bit, for the same seed.

The ``cuda`` tests (skipped without a card) hold the captured graphs to the
eager loop's bits at the tiny preset's width, the replay loop to no host
sync, the wrappers' counters after replays, and a replay after the
GroupNorm workspace grew to the plain sums. JAX is imported inside the
tests that use it: the card's machine has none and runs this file's
``cuda`` tests with ``--noconftest``.
"""

import json
import logging
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ldm3d_torch.cli import common as port_common
from ldm3d_torch.cli.common import save_two_stage
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.data import val_condition_volumes
from ldm3d_torch.diffusion import DDIMScheduler, inferer
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.ops import graphs
from ldm3d_torch.ops import groupnorm as tgn
from ldm3d_torch.utils.nifti import read_nifti

torch.set_num_threads(1)

ATOL_SAMPLE = 1e-4
SCALE_FACTOR = 0.8
N_TRAIN = 16
SCHED_CFG = {"num_train_timesteps": N_TRAIN, "schedule": "scaled_linear_beta",
             "beta_start": 0.0015, "beta_end": 0.0195, "prediction_type": "epsilon"}
SHAPE = (2, 3, 3, 3, 2)

# the cases of test_torch_samplers.py: (sampler, steps, eta) on each spacing
# it takes
SAMPLERS = [("ddpm", None, None), ("ddpm", 4, None), ("ddim", 4, None), ("ddim", 4, 0.7),
            ("dpm", 6, None), ("dpm3", 6, None)]
CASES = [(s, n, eta, spacing) for s, n, eta in SAMPLERS
         for spacing in ("leading", "trailing", "karras")
         if not (spacing == "karras" and (s == "ddpm" or eta is not None))]


def _scheduler(sampler, steps, eta, spacing, cfg=SCHED_CFG):
    if eta is not None:
        return DDIMScheduler.create(**cfg, num_inference_steps=steps, eta=eta,
                                    timestep_spacing=spacing)
    return port_common.make_sampling_scheduler(sampler, steps, cfg, spacing)


def _unet(x, t):
    """A fixed analytic eps-model of the latent channels (the condition's
    are ignored past the concat)."""
    tt = t.reshape(-1, 1, 1, 1, 1) / N_TRAIN
    x = x[..., :SHAPE[-1]]
    return 0.6 * torch.tanh(x) * (1.0 + tt) + 0.1 * torch.sin(3.0 * x) - 0.05 * tt


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("sampler,steps,eta,spacing", CASES)
def test_step_table_loop_gives_the_eager_bits(sampler, steps, eta, spacing, prediction_type):
    """The captured sampler's step body, run eagerly over the scheduler's
    step table, against ``sample_latents`` with the same step noises:
    torch.equal, with and without a condition and guidance, fp32 and bf16,
    and again on a second call of the same sampler."""
    sched = _scheduler(sampler, steps, eta, spacing, dict(SCHED_CFG,
                                                          prediction_type=prediction_type))
    table = sched.step_table()
    assert table.timesteps.tolist() == list(sched.timesteps)
    assert table.values.shape == (len(sched.timesteps), len(table.columns))
    assert table.draws_noise == (sampler == "ddpm" or eta is not None)
    rng = np.random.default_rng(len(sched.timesteps))
    noise = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    cond = torch.from_numpy(rng.standard_normal(SHAPE[:-1] + (1,)).astype(np.float32))
    draws = [torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
             for _ in sched.timesteps] if table.draws_noise else None
    for condition, guidance, dtype in ((None, 1.0, torch.float32), (cond, 1.0, torch.float32),
                                       (cond, 2.0, torch.float32), (cond, 2.0, torch.bfloat16)):
        want = inferer.sample_latents(_unet, sched, noise.to(dtype), condition, guidance,
                                      step_noises=draws)
        fused = inferer.CapturedSampler(
            _unet, None, sched, SHAPE, dtype, "cpu",
            condition_shape=None if condition is None else condition.shape,
            guidance_scale=guidance)
        for _ in range(2):
            got = fused.sample_latents(noise.to(dtype), condition, draws)
            assert got.dtype == dtype and torch.equal(got, want), (condition is None, guidance,
                                                                   dtype)


def test_captured_sampler_rejects_inputs_it_was_not_built_for():
    sched = _scheduler("ddpm", 4, None, "leading")
    fused = inferer.CapturedSampler(_unet, None, sched, SHAPE, torch.float32, "cpu")
    noise = torch.zeros(SHAPE)
    draws = [torch.zeros(SHAPE)] * 4
    with pytest.raises(ValueError, match="noise"):
        fused.sample_latents(torch.zeros((1, *SHAPE[1:])), None, draws)
    with pytest.raises(ValueError, match="condition"):
        fused.sample_latents(noise, torch.zeros(SHAPE), draws)
    with pytest.raises(ValueError, match="4 step noises"):
        fused.sample_latents(noise, None, None)
    with pytest.raises(ValueError, match="3 step noises for 4 steps"):
        fused.sample_latents(noise, None, draws[:3])
    with pytest.raises(ValueError, match="without a decode"):
        fused.sample(noise, None, draws)
    ddim = inferer.CapturedSampler(_unet, None, _scheduler("ddim", 4, None, "leading"), SHAPE,
                                   torch.float32, "cpu")
    with pytest.raises(ValueError, match="draws no step noise"):
        ddim.sample_latents(noise, None, draws)
    with pytest.raises(ValueError, match="on the card"):
        ddim.capture()


@pytest.mark.parametrize("sampler,eta", [("ddpm", None), ("ddim", 0.5)])
def test_noisy_step_requires_its_noise(sampler, eta):
    """A step that adds noise raises without its z; the last step, which
    adds none, takes None."""
    sched = _scheduler(sampler, 4, eta, "leading")
    x = torch.zeros(SHAPE)
    first, last = sched.timesteps[0], sched.timesteps[-1]
    with pytest.raises(ValueError, match="z is required"):
        sched.step_with_noise(x, first, x, None)
    assert torch.isfinite(sched.step_with_noise(x, last, x, None)).all()


def test_launch_counts_delta_adds_and_takes_back():
    """``ops.graphs``' count arithmetic, which every replay applies."""
    from ldm3d_torch.ops import attention as tattn

    before = graphs.launch_counts()
    case = ((1, 8, 2, 64), 8, "bfloat16")
    delta = {"flash_attention_fwd": {"launches": 3, "route_launches": {"bf16": 2, "fp32": 1},
                                     "cases": {case: 2, (case[0], 8, "float32"): 1}},
             "gn_sums": {"launches": 2, "cases": {("shape",): 2}}}
    graphs.add_counts(delta)
    after = graphs.launch_counts()
    moved = graphs.launch_delta(after, before)
    assert moved["flash_attention_fwd"] == delta["flash_attention_fwd"]
    assert moved["gn_sums"] == delta["gn_sums"]
    assert moved["conv3d_igemm"] == {"launches": 0}
    graphs.add_counts(delta, -1)
    assert tattn.flash_attention_fwd.launches == before["flash_attention_fwd"]["launches"]
    assert tgn.gn_sums.cases.get(("shape",), 0) == 0
    assert case not in tattn.flash_attention_fwd.cases


# --- the CLI on the tiny preset's models


@pytest.fixture(scope="module")
def tiny():
    from test_torch_models import jax_models, port_models

    cfg, jae, ae_params, junet, u_params = jax_models("config_tiny_cpu.json", seed=3)
    tae, tunet = port_models(cfg, ae_params, u_params)
    return cfg, jae, ae_params, junet, u_params, tae, tunet


def _env(tmp_path, model_dir):
    env = {"model_dir": str(model_dir), "output_dir": str(tmp_path / "out"), "seed": 5,
           "synthetic_data": True, "synthetic_num": 4, "synthetic_shape": [40, 40, 40]}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


def _cli(env, *extra, timings=None) -> np.ndarray:
    written = port_inference(["-c", preset_path("config_tiny_cpu.json"), "-e", env,
                              "--device", "cpu", *extra], timings=timings)
    return np.stack([read_nifti(p)[0] for p in written])


def _jax_pipeline(tiny, sched, images, eps, noise, guidance, key_seed=0):
    """The JAX pipeline: posterior with the given eps, the scheduler's loop
    with the key's per-step draws, ``/ scale_factor``, decode."""
    import jax
    import jax.numpy as jnp
    from test_torch_models import ref_jit

    from ldm3d_tpu.diffusion import inferer as jax_inferer

    _, jae, ae_params, junet, u_params, _, _ = tiny

    def run(images, eps, noise):
        mu, sigma = jae.apply({"params": ae_params}, images, method="encode")
        return jax_inferer.sample(
            lambda z, t: junet.apply({"params": u_params}, z, t),
            lambda z: jae.apply({"params": ae_params}, z, method="decode_stage_2_outputs"),
            sched, noise, jax.random.PRNGKey(key_seed), condition=mu + sigma * eps,
            scale_factor=SCALE_FACTOR, guidance_scale=guidance)

    return np.asarray(ref_jit(run)(jnp.asarray(images), jnp.asarray(eps), jnp.asarray(noise)))


@pytest.mark.parametrize("sampler,guidance,batch", [("ddim", "1.0", 1), ("dpm3", "1.0", 1),
                                                    ("ddim", "2.0", 2), ("dpm3", "2.0", 2)])
def test_fused_cli_matches_jax_pipeline(tiny, tmp_path, sampler, guidance, batch):
    """``--fused-decode --device cpu`` against the JAX pipeline on the CLI's
    own inputs (its conditioning volumes, its generator's posterior noise
    and initial noise), within ATOL_SAMPLE."""
    from ldm3d_tpu.cli import common as jax_common

    cfg = tiny[0]
    save_two_stage(str(tmp_path / "ckpt"), tiny[5], tiny[6], SCALE_FACTOR)
    env = _env(tmp_path, tmp_path / "ckpt")
    timings = {}
    vol = _cli(env, "--sampler", sampler, "--steps", "6", "--guidance", guidance,
               "--batch", str(batch), "--fused-decode", timings=timings)
    assert vol.shape == (batch, 32, 32, 32) and np.isfinite(vol).all()
    assert all(len(timings[k]) == 1 for k in ("denoise_ms", "decode_ms", "sample_ms"))
    assert "capture_ms" not in timings  # nothing is captured on the CPU

    args = SimpleNamespace(**json.loads(open(env).read()))
    patch = cfg["diffusion_train"]["patch_size"]
    images = np.clip(val_condition_volumes(args, batch, patch), 0, 1)
    gen = torch.Generator().manual_seed(5)
    latent = (batch, 8, 8, 8, cfg["latent_channels"])
    eps = torch.randn(latent, generator=gen).numpy()
    noise = torch.randn(latent, generator=gen).numpy()
    sched = jax_common.make_sampling_scheduler(sampler, 6, dict(SCHED_CFG))
    ref = _jax_pipeline(tiny, sched, images, eps, noise, float(guidance))
    np.testing.assert_allclose(vol, ref[..., 0], atol=ATOL_SAMPLE, rtol=0)


def test_captured_ddpm_matches_jax_with_its_draws(tiny):
    """ddpm over the tiny preset's full schedule, batch 2, guidance 2.0: the
    captured sampler's plain version fed JAX's own per-step draws (one key a
    step from ``jax.random.split``) against the JAX pipeline, within
    ATOL_SAMPLE."""
    import jax
    import jax.numpy as jnp

    from ldm3d_tpu.cli import common as jax_common

    cfg, jae, ae_params, _, _, tae, tunet = tiny
    patch = cfg["diffusion_train"]["patch_size"]
    latent = (2, *[p // 4 for p in patch], cfg["latent_channels"])
    rng = np.random.default_rng(9)
    images = rng.uniform(0, 1, (2, *patch, 1)).astype(np.float32)
    eps = rng.standard_normal(latent, dtype=np.float32)
    noise = rng.standard_normal(latent, dtype=np.float32)
    jsched = jax_common.make_sampling_scheduler("ddpm", None, dict(SCHED_CFG))
    ref = _jax_pipeline(tiny, jsched, images, eps, noise, 2.0, key_seed=4)

    sched = port_common.make_sampling_scheduler("ddpm", None, dict(SCHED_CFG))
    draws = [torch.from_numpy(np.array(jax.random.normal(k, latent, jnp.float32)))
             for k in jax.random.split(jax.random.PRNGKey(4), len(sched.timesteps))]
    with torch.no_grad():
        cond = tae.encode_stage_2_inputs(torch.from_numpy(images), torch.from_numpy(eps))
    fused = inferer.CapturedSampler(tunet, tae.decode_stage_2_outputs, sched, latent,
                                    torch.float32, "cpu", condition_shape=cond.shape,
                                    guidance_scale=2.0, scale_factor=SCALE_FACTOR)
    out = fused.sample(torch.from_numpy(noise), cond, draws).numpy()
    assert out.shape == images.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL_SAMPLE, rtol=0)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm3"])
def test_fused_cli_writes_the_eager_volumes(tiny, tmp_path, sampler, caplog):
    """``-n 2 --decode-chunk 1 --fused-decode`` and the eager CLI with the
    same argv and seed write the same volumes, bit for bit (ddpm's step
    noises drawn before the loop in the eager loop's order); the fused run
    logs that it ignores the chunk, as the JAX CLI does."""
    save_two_stage(str(tmp_path / "ckpt"), tiny[5], tiny[6], SCALE_FACTOR)
    env = _env(tmp_path, tmp_path / "ckpt")
    argv = ("--sampler", sampler, "--steps", "4", "-n", "2", "--decode-chunk", "1")
    eager = _cli(env, *argv)
    with caplog.at_level(logging.INFO, logger="inference"):
        fused = _cli(env, *argv, "--fused-decode")
    assert fused.shape == eager.shape == (2, 32, 32, 32)
    assert np.array_equal(fused, eager)
    assert any("--decode-chunk ignored: --fused-decode" in r.getMessage() for r in caplog.records)


# --- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def _tiny_models(dtype):
    """The tiny preset's VAE and UNet on the card, random weights from a seed
    (the UNet's zero-init output conv drawn too), in ``dtype``'s compute."""
    ns = SimpleNamespace(**load_json(preset_path("config_tiny_cpu.json")))
    gen = torch.Generator().manual_seed(2)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval()
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen).eval()
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    ae.compute_dtype = unet.compute_dtype = dtype
    return ae.cuda(), unet.cuda()


CARD_CASES = [("ddim", 8, 1.0, "float32"), ("ddpm", None, 2.0, "bfloat16"),
              ("dpm3", 6, 2.0, "bfloat16"), ("ddim", 8, 2.0, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("sampler,steps,guidance,dtype", CARD_CASES)
def test_captured_sample_gives_the_eager_bits_on_card(sampler, steps, guidance, dtype):
    """At the tiny preset's width, batch 2, conditional: two samples through
    the captured graphs give the eager loop and decode's bits (the same step
    noises), and the kernels' counters move by exactly the eager run's
    launches a sample; the capture is made once (one step graph, two for
    ddpm, whose last step adds no noise, and the decode's)."""
    _card()
    dt = getattr(torch, dtype)
    ae, unet = _tiny_models(dt)
    sched = port_common.make_sampling_scheduler(sampler, steps, dict(SCHED_CFG))
    gen = torch.Generator().manual_seed(7)
    latent = (2, 8, 8, 8, 4)
    images = torch.rand((2, 32, 32, 32, 1), generator=gen).cuda().to(dt)
    with torch.no_grad():
        cond = ae.encode_stage_2_inputs(images, torch.randn(latent, generator=gen).cuda())
    fused = inferer.CapturedSampler(unet, ae.decode_stage_2_outputs, sched, latent, dt, "cuda",
                                    condition_shape=cond.shape, guidance_scale=guidance,
                                    scale_factor=SCALE_FACTOR)
    for _ in range(2):
        noise = torch.randn(latent, generator=gen).cuda().to(dt)
        draws = ([torch.randn(latent, generator=gen) for _ in sched.timesteps]
                 if fused.draws_noise else None)
        before = graphs.launch_counts()
        want = inferer.sample(unet, ae.decode_stage_2_outputs, sched, noise, cond,
                              SCALE_FACTOR, guidance, step_noises=draws)
        torch.cuda.synchronize()
        eager = graphs.launch_delta(graphs.launch_counts(), before)
        first = not fused.graphs
        before = graphs.launch_counts()
        got = fused.sample(noise, cond, draws)
        torch.cuda.synchronize()
        moved = graphs.launch_delta(graphs.launch_counts(), before)
        if first:  # the warm-up before the capture launched eagerly
            graphs.add_counts(fused.warmup_launches, -1)
            moved = graphs.launch_delta(graphs.launch_counts(), before)
            graphs.add_counts(fused.warmup_launches)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert eager["flash_attention_fwd"]["launches"] > 0 and eager["gn_sums"]["launches"] > 0
        assert moved == eager
    assert len(fused.graphs) == (2 if sampler == "ddpm" else 1)


@pytest.mark.cuda
def test_replay_loop_makes_no_host_sync_on_card(monkeypatch):
    """The replay loop runs under ``set_sync_debug_mode("error")`` and
    leaves the mode as it found it: a host sync inside it raises, and
    nothing falls back to the eager loop."""
    _card()
    ae, unet = _tiny_models(torch.bfloat16)
    sched = port_common.make_sampling_scheduler("ddim", 4, dict(SCHED_CFG))
    latent = (1, 8, 8, 8, 4)
    fused = inferer.CapturedSampler(lambda x, t: unet(torch.cat([x, x], dim=-1), t),
                                    ae.decode_stage_2_outputs, sched, latent, torch.bfloat16,
                                    "cuda", scale_factor=SCALE_FACTOR)
    noise = torch.randn(latent, device="cuda").to(torch.bfloat16)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        out = fused.sample(noise)
        assert torch.isfinite(out.float()).all()
        assert torch.cuda.get_sync_debug_mode() == 1
        step_graph = fused.graphs[False]
        replay = step_graph.replay

        def replay_then_sync():
            replay()
            torch.cuda.current_stream().synchronize()

        monkeypatch.setattr(step_graph, "replay", replay_then_sync)
        launches = graphs.launch_counts()
        with pytest.raises(RuntimeError, match="synchroniz"):
            fused.sample(noise)
        assert torch.cuda.get_sync_debug_mode() == 1
        # one replay ran before the sync raised; the decode never did
        moved = graphs.launch_delta(graphs.launch_counts(), launches)
        assert moved == step_graph.launches
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.cuda
def test_counted_graph_counts_each_replay_on_card():
    """A graph of three B4 calls and one attention forward adds exactly its
    launches (and cases, and routes) on each of five replays, none at
    capture, and each replay recomputes the plain version's sums."""
    _card()
    from ldm3d_torch.ops import attention as tattn

    x = (torch.randn((1, 64, 8, 8, 8), device="cuda") + 0.3).contiguous(
        memory_format=torch.channels_last_3d)
    q = torch.randn((1, 64, 2, 16), device="cuda").to(torch.bfloat16)

    def calls():
        return [tgn.gn_sums(x) for _ in range(3)], tattn.flash_attention_fwd(q, q, q)

    calls()
    torch.cuda.synchronize()
    graph = graphs.CountedGraph()
    before = graphs.launch_counts()
    sums, _ = graph.capture(calls)
    assert graphs.launch_delta(graphs.launch_counts(), before) == graphs.launch_delta(
        before, before)
    assert graph.launches["gn_sums"]["launches"] == 3
    assert graph.launches["flash_attention_fwd"]["launches"] == 1
    assert graph.launches["flash_attention_fwd"]["route_launches"] == {"bf16": 1}
    for n in range(1, 6):
        x.mul_(1.5)
        graph.replay()
        torch.cuda.synchronize()
        moved = graphs.launch_delta(graphs.launch_counts(), before)
        assert moved["gn_sums"]["launches"] == 3 * n
        assert sum(moved["gn_sums"]["cases"].values()) == 3 * n
        assert moved["flash_attention_fwd"]["route_launches"] == {"bf16": n}
        ref = tgn.gn_sums_reference(x)
        for s1, s2 in sums:
            assert torch.allclose(s1, ref[0], rtol=1e-5, atol=1e-3)
            assert torch.allclose(s2, ref[1], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_groupnorm_workspace_outlives_growth_after_capture_on_card():
    """A graph keeps the GroupNorm workspace it baked in: an eager call at a
    larger input grows the workspace after the capture, and a replay still
    gives the plain version's sums (and the eager call its own); growing the
    workspace during a capture raises."""
    _card()
    torch.cuda.synchronize()
    tgn._WS.partials.clear()
    tgn._WS.counters.clear()
    small = (torch.randn((1, 64, 16, 16, 16), device="cuda") + 0.3).contiguous(
        memory_format=torch.channels_last_3d)
    big = (torch.randn((20, 512, 16, 16, 16), device="cuda") * 0.5).contiguous(
        memory_format=torch.channels_last_3d)
    tgn.gn_sums(small)
    torch.cuda.synchronize()
    baked = [t.data_ptr() for t in tgn.workspace_buffers()]
    graph = graphs.CountedGraph()
    sums = graph.capture(lambda: tgn.gn_sums(small))
    got_big = tgn.gn_sums(big)
    assert [t.data_ptr() for t in tgn.workspace_buffers()] != baked  # it grew
    # blocks of the replaced buffers' sizes, filled: they would take freed memory
    fill = [torch.full((1 << 16,), math.nan, device="cuda") for _ in range(8)]
    fill += [torch.full((1 << 12,), -1, dtype=torch.int32, device="cuda") for _ in range(8)]
    small.mul_(-2.0)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(sums, tgn.gn_sums_reference(small)):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-3)
    for got, want in zip(got_big, tgn.gn_sums_reference(big)):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-2)
    del fill
    bigger = torch.randn((40, 512, 16, 16, 16), device="cuda").contiguous(
        memory_format=torch.channels_last_3d)
    with pytest.raises(RuntimeError, match="workspace would grow during a CUDA graph capture"):
        graphs.CountedGraph().capture(lambda: tgn.gn_sums(bigger))
