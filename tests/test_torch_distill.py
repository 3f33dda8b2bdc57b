"""Progressive distillation in the port, held against the JAX package.

* ``pred_x0_and_eps`` (the division form, one alpha_bar a sample) for every
  prediction type against ``ldm3d_tpu.diffusion.schedulers._pred_x0_and_eps``
  (1e-6 relative: the same fp32 formulas); ``student_timesteps`` bit-equal;
  the ``DistillConfig`` checks raise as JAX's do.
* One distillation step (``make_distillation_step``) against
  ``ldm3d_tpu.training.make_distillation_step`` on the ``config_micro_cpu``
  models with the same params and the draws rebuilt from the JAX key (the
  two posterior epsilons as the Flax VAE's ``make_rng("sample")`` derives
  them, the noise, the student step indices), epsilon -> epsilon, epsilon ->
  v_prediction, guidance distillation at 2.0 and unconditional. fp32 on the
  CPU. Loss and ``grad_norm`` within 1e-5 relative, the student's params
  after the update within 2 lr + 1e-6 (the bar ``tests/test_torch_train.py``
  holds a stage-2 update to: Adam's first update moves every element by
  about lr); the teacher gets no gradient. (That step's tests are in
  ``tests/test_torch_distill_step.py``.)
* The chain ``train_diffusion -> distill -> inference --use-distilled ->
  evaluate --use-distilled`` on the port alone (``--device cpu``, the tiny
  preset), the distilled checkpoint's meta holding the keys the JAX CLI
  writes (read from its source with ``ast``); the inference CLI's
  ``--use-distilled`` rules; the server serving the student and rejecting
  what the JAX server rejects.
* ``cuda`` tests (skipped without a card): a distillation step's launch
  counts by kernel. JAX is imported inside the tests that use it: the card's
  machine has none.
"""

import ast
import copy
import json
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli.common import load_distilled, save_two_stage
from ldm3d_torch.cli.distill import main as port_distill
from ldm3d_torch.cli.evaluate import main as port_evaluate
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.diffusion import DDPMScheduler, GridDDIMScheduler, pred_x0_and_eps
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.serving.model_server import ModelServer
from ldm3d_torch.training import (
    DistillConfig,
    TrainState,
    make_diffusion_optimizer,
    make_distillation_step,
    student_timesteps,
)
from ldm3d_torch.utils.nifti import read_nifti

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
SCALE = 0.9
N_TRAIN = 16


# --- the pieces -----------------------------------------------------------------

@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_pred_x0_and_eps_matches_jax(prediction_type):
    import jax.numpy as jnp

    from ldm3d_tpu.diffusion.schedulers import _pred_x0_and_eps

    rng = np.random.default_rng(0)
    pred, x_t = (rng.standard_normal((3, 2, 2, 2, 2)).astype(np.float32) for _ in range(2))
    a_t = np.array([0.02, 0.5, 0.998], np.float32).reshape(3, 1, 1, 1, 1)
    ref = _pred_x0_and_eps(jnp.asarray(pred), jnp.asarray(x_t), jnp.asarray(a_t),
                           prediction_type)
    out = pred_x0_and_eps(torch.from_numpy(pred), torch.from_numpy(x_t), torch.from_numpy(a_t),
                          prediction_type)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown prediction_type"):
        pred_x0_and_eps(torch.from_numpy(pred), torch.from_numpy(x_t), torch.from_numpy(a_t),
                        "x_start")


@pytest.mark.parametrize("n_train,teacher_steps", [(16, 2), (16, 4), (16, 8), (1000, 64),
                                                   (1000, 8)])
def test_student_timesteps_match_jax(n_train, teacher_steps):
    from ldm3d_tpu.training import student_timesteps as jax_student_timesteps

    out = student_timesteps(n_train, teacher_steps)
    ref = jax_student_timesteps(n_train, teacher_steps)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


@pytest.mark.parametrize("kwargs", [dict(teacher_steps=3), dict(teacher_steps=0),
                                    dict(teacher_steps=4, conditional=False,
                                         guidance_scale=2.0)])
def test_distill_config_checks_raise_as_jax(kwargs):
    from ldm3d_tpu.training import DistillConfig as JaxDistillConfig

    with pytest.raises(ValueError) as ref:
        JaxDistillConfig(**kwargs)
    with pytest.raises(ValueError) as out:
        DistillConfig(**kwargs)
    assert str(out.value) == str(ref.value)


def test_ddpm_replace_changes_only_the_prediction_type():
    sched = DDPMScheduler.create(num_train_timesteps=N_TRAIN)
    other = sched.replace(prediction_type="v_prediction")
    assert other.prediction_type == "v_prediction" and sched.prediction_type == "epsilon"
    assert other.alphas_cumprod is sched.alphas_cumprod and other.timesteps == sched.timesteps


# --- one step against the JAX step: tests/test_torch_distill_step.py -------------------


def test_step_draws_from_the_generator_reproducibly():
    ns = _tiny_ns()
    gen = torch.Generator().manual_seed(0)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval()
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen).eval().requires_grad_(False)
    step = make_distillation_step(unet, ae, DDPMScheduler.create(num_train_timesteps=N_TRAIN),
                                  DistillConfig(teacher_steps=4))
    batch = {k: torch.rand((2, 16, 16, 16, 1), generator=gen) for k in ("image", "label")}
    losses = []
    for seed in (1, 1, 2):
        student = copy.deepcopy(unet).requires_grad_(True)
        state = TrainState(student, make_diffusion_optimizer(student.parameters(), lambda _: LR))
        losses.append(float(step(state, unet, batch, SCALE,
                                 torch.Generator().manual_seed(seed))["distill_loss"]))
    assert losses[0] == losses[1] != losses[2] and all(np.isfinite(losses))


def _tiny_ns():
    from types import SimpleNamespace

    return SimpleNamespace(**load_json(preset_path("config_tiny_cpu.json")))


# --- the chain on the port alone -----------------------------------------------------

def _jax_cli_meta_keys() -> set:
    """The meta keys ``ldm3d_tpu/cli/distill.py`` saves the distilled role
    with, read from its ``ckpt.save("distilled", ..., meta={...})`` call."""
    tree = ast.parse((ROOT / "ldm3d_tpu" / "cli" / "distill.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "save"
                and node.args and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "distilled"):
            meta = next(k.value for k in node.keywords if k.arg == "meta")
            return {key.value for key in meta.keys}
    raise AssertionError("the JAX CLI saves no distilled role")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """train_diffusion (1 epoch) over a seeded tiny VAE, then distill (8 -> 2
    steps in two rounds, v_prediction student), all through the port's CLIs
    on the CPU."""
    tmp = tmp_path_factory.mktemp("chain")
    ns = _tiny_ns()
    gen = torch.Generator().manual_seed(1)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
    CheckpointManager(str(tmp / "ckpt"), "autoencoder").save("best", {"state_dict": ae.state_dict()})
    env = {"model_dir": str(tmp / "ckpt"), "output_dir": str(tmp / "out"),
           "tfevent_path": str(tmp / "tb"), "seed": 0, "synthetic_data": True,
           "synthetic_num": 10, "synthetic_shape": [32, 32, 32], "val_fraction": 0.3,
           "resume_ckpt": False}
    env_path = tmp / "env.json"
    env_path.write_text(json.dumps(env))
    cfg = preset_path("config_tiny_cpu.json")
    base = ["-c", cfg, "-e", str(env_path), "--device", "cpu"]
    port_train(base + ["--max-epochs", "1", "--no-images", "--cond-dropout", "0.2"])
    timings: dict = {}
    final = port_distill(base + ["--teacher-steps", "8", "--rounds", "2",
                                 "--steps-per-round", "3", "--student-prediction",
                                 "v_prediction"], timings=timings)
    return {"tmp": tmp, "env": str(env_path), "cfg": cfg, "base": base, "final": final,
            "timings": timings}


def test_distill_cli_writes_the_jax_meta(chain):
    ckpt = CheckpointManager(str(chain["tmp"] / "ckpt"), "diffusion")
    meta = ckpt.load_meta("distilled")
    assert set(meta) == _jax_cli_meta_keys()
    assert meta["timesteps"] == [15, 8] and meta["num_steps"] == 2
    assert meta["teacher_steps"] == 8 and meta["rounds"] == 2
    assert meta["prediction_type"] == "v_prediction" and meta["teacher_role"] == "best"
    assert meta["guidance_scale"] == 1.0
    assert meta["scale_factor"] == ckpt.load_meta("best")["scale_factor"]
    assert np.isfinite(meta["final_loss"]) and meta["final_loss"] == chain["final"]
    t = chain["timings"]
    assert [len(r) for r in t["step_ms"]] == [3, 3]
    # the second round's teacher is the first round's student, its gradients cleared
    assert t["teacher_params_with_grad"] == [0, 0]
    assert np.mean(t["distill_loss"][-1]) == pytest.approx(chain["final"])
    # the student moved away from the teacher
    best = ckpt.load("best")["state_dict"]
    student = ckpt.load("distilled")["state_dict"]
    assert any(not torch.equal(best[k], student[k]) for k in best)


def test_load_distilled_builds_the_grid_scheduler(chain):
    ns = _tiny_ns()
    unet = define_instance(ns, "diffusion_def")
    sched_cfg = {"num_train_timesteps": N_TRAIN, "beta_start": 0.0015, "beta_end": 0.0195,
                 "prediction_type": "epsilon"}
    out, sched, meta = load_distilled(str(chain["tmp"] / "ckpt"), unet, sched_cfg)
    assert out is unet and isinstance(sched, GridDDIMScheduler)
    assert sched.timesteps == [15, 8] and sched.prediction_type == "v_prediction"
    with pytest.raises(FileNotFoundError, match="no 'distilled' checkpoint found; run "
                                                "ldm3d-distill first"):
        load_distilled(str(chain["tmp"] / "empty"), unet, sched_cfg)


def test_inference_use_distilled_runs_eager_and_fused_alike(chain, caplog):
    caplog.set_level(logging.INFO)
    base = chain["base"]
    vols = []
    for extra in ([], ["--fused-decode"]):
        timings: dict = {}
        written = port_inference(base + ["--use-distilled", "--sampler", "dpm", *extra],
                                 timings=timings)
        vols.append(np.stack([read_nifti(p)[0] for p in written]))
        assert len(timings["denoise_ms"]) == 1
    assert vols[0].shape == (1, 32, 32, 32) and np.isfinite(vols[0]).all()
    assert np.array_equal(vols[0], vols[1])
    assert any("--use-distilled overrides" in r.getMessage() for r in caplog.records)


def test_evaluate_use_distilled_writes_a_report(chain, tmp_path):
    report_path = tmp_path / "report.json"
    timings: dict = {}
    report = port_evaluate(chain["base"] + ["--use-distilled", "-n", "2", "--report",
                                            str(report_path)], timings=timings)
    saved = json.loads(report_path.read_text())
    assert saved["num_samples"] == report.num_samples == 2
    assert saved["frechet"] is not None and 0.0 <= saved["score"] <= 1.0
    assert len(timings["sample_ms"]) == 2 and timings["metrics_ms"] > 0


# --- the --use-distilled rules of the inference CLI ---------------------------------

def _two_stage_env(tmp_path):
    ns = _tiny_ns()
    gen = torch.Generator().manual_seed(3)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    save_two_stage(str(tmp_path / "ckpt"), ae, unet, 0.8)
    env = {"model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"), "seed": 0,
           "synthetic_data": True, "synthetic_num": 4, "synthetic_shape": [32, 32, 32]}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path), ae, unet


@pytest.mark.parametrize("cli", ["inference", "evaluate"])
def test_use_distilled_rules(cli, tmp_path, monkeypatch):
    """Without a distilled checkpoint the flag raises FileNotFoundError; with
    --use-ema, and with --guidance (from the meta alone, before any weights
    load), ValueError with the JAX CLI's messages."""
    run = {"inference": port_inference, "evaluate": port_evaluate}[cli]
    env, _, unet = _two_stage_env(tmp_path)
    base = ["-c", preset_path("config_tiny_cpu.json"), "-e", env, "--device", "cpu",
            "--use-distilled"]
    with pytest.raises(FileNotFoundError, match="no 'distilled' checkpoint found"):
        run(base)
    with pytest.raises(ValueError, match="--use-distilled and --use-ema are mutually exclusive"):
        run(base + ["--use-ema"])
    CheckpointManager(str(tmp_path / "ckpt"), "diffusion").save(
        "distilled", {"state_dict": unet.state_dict()}, {"timesteps": [15, 8], "num_steps": 2,
                                                         "guidance_scale": 3.0})
    import ldm3d_torch.cli.common as common

    def no_weights(*args, **kwargs):
        raise AssertionError("weights loaded before the --guidance check")

    monkeypatch.setattr(common.CheckpointManager, "load", no_weights)
    with pytest.raises(ValueError, match=r"--guidance is unavailable with --use-distilled: "
                                         r"the student bakes guidance w=3.0 in"):
        run(base + ["--guidance", "2.0"])


# --- serving the student -------------------------------------------------------------

def test_server_serves_the_student_and_rejects_what_jax_rejects(chain):
    srv = ModelServer(chain["cfg"], chain["env"], sampler="distilled", batch=2, device="cpu")
    srv.load_model()
    try:
        assert not srv.is_dummy and srv.steps == 2
        out = srv.generate(num_samples=1, seed=3)
        assert out["sampler"] == "distilled" and out["inference_steps"] == 2
        assert out["timestep_spacing"] is None and out["guidance_scale"] == 1.0
        again = srv.generate(num_samples=1, seed=3, sampler="distilled", inference_steps=2)
        assert again["samples"][0]["data"] == out["samples"][0]["data"]
        for kwargs, match in ((dict(sampler="ddim"), "per-request sampler overrides"),
                              (dict(inference_steps=4), "fixed 2-step grid"),
                              (dict(guidance_scale=2.0), "guidance is unavailable"),
                              (dict(timestep_spacing="leading"), "timestep_spacing is "
                                                                 "unavailable")):
            with pytest.raises(ValueError, match=match):
                srv.generate(num_samples=1, seed=0, **kwargs)
    finally:
        if srv._batcher is not None:
            srv._batcher.close()
    plain = ModelServer(chain["cfg"], chain["env"], sampler="ddim", steps=4, device="cpu")
    plain.load_model()
    with pytest.raises(ValueError, match="start the server with sampler='distilled'"):
        plain.generate(num_samples=1, seed=0, sampler="distilled")
    with pytest.raises(ValueError, match="fixed 2-step grid; --steps 4"):
        ModelServer(chain["cfg"], chain["env"], sampler="distilled", steps=4,
                    device="cpu").load_model()


# --- on the card ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,guidance", [("bfloat16", 1.0), ("float32", 2.0)])
def test_distillation_step_launch_counts_on_card(dtype, guidance):
    """One step at the tiny preset's width launches, by kernel: the attention
    forward three times a UNet call's (two teacher calls, batched CFG
    included, and the student's) plus twice the encoder's; dQ and dK/dV once
    a UNet attention (the student's backward); the GroupNorm sums three times
    a UNet call's plus twice the encoder's, their backward once a UNet
    GroupNorm; no conv kernel; no teacher gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from ldm3d_torch.nn.blocks import AttentionBlock3D, GroupNorm32
    from ldm3d_torch.ops import graphs

    ns = _tiny_ns()
    gen = torch.Generator().manual_seed(2)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen).eval().requires_grad_(False)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen).eval().requires_grad_(False)
    ae.compute_dtype = unet.compute_dtype = getattr(torch, dtype)
    ae, unet = ae.cuda(), unet.cuda()
    student = copy.deepcopy(unet).requires_grad_(True).train()
    state = TrainState(student, make_diffusion_optimizer(student.parameters(), lambda _: LR))
    step = make_distillation_step(unet, ae, DDPMScheduler.create(num_train_timesteps=N_TRAIN),
                                  DistillConfig(teacher_steps=4, guidance_scale=guidance))
    batch = {k: torch.rand((2, 32, 32, 32, 1), generator=gen).cuda() for k in ("image", "label")}
    before = graphs.launch_counts()
    m = step(state, unet, batch, SCALE, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    delta = graphs.launch_delta(graphs.launch_counts(), before)

    def count(module, cls):
        return sum(isinstance(mod, cls) for mod in module.modules())

    enc_attn, u_attn = count(ae.encoder, AttentionBlock3D), count(unet, AttentionBlock3D)
    enc_gn, u_gn = count(ae.encoder, GroupNorm32), count(unet, GroupNorm32)
    launches = {name: entry["launches"] for name, entry in delta.items()}
    assert launches == {"flash_attention_fwd": 3 * u_attn + 2 * enc_attn,
                        "flash_attention_bwd_dq": u_attn, "flash_attention_bwd_dkv": u_attn,
                        "gn_sums": 3 * u_gn + 2 * enc_gn, "gn_bwd_sums": u_gn,
                        "conv3d_igemm": 0}, launches
    assert math.isfinite(float(m["distill_loss"])) and math.isfinite(float(m["grad_norm"]))
    assert all(p.grad is None for p in unet.parameters())
