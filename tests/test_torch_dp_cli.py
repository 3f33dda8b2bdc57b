"""The port's CLIs at ``-g 2 --device cpu`` against the same CLIs at ``-g 1``
on the same global batch.

``train_diffusion -g 2`` and ``inference -g 2`` go through the launcher
(two spawned ranks over gloo, ``ldm3d_torch.parallel.launch``), ``inference
--multihost`` through ``torchrun`` (``torch.distributed.run``); the stage-1
trainer and the distillation CLI run their ``main`` with ``-g 2`` on the
ranks of one :class:`RankPool` (the path a launched rank takes). The
environment holds 4 training and 4 validation volumes at 16^3 (the micro
patch, so random crops are the whole volume): one global batch of 4 is
every rank's share end to end at world 2 and the whole split at world 1.
Stage 1 at world 2 scales its LR by ``scale_lr_for_world`` (sqrt(2) / 2),
so its world-1 twin is given that LR. Held: every logged loss and
``grad_norm`` within atol 2e-5 and rtol 2e-5 (JAX's bar), the parameters
after the run within 2 lr + 1e-6 (Adam's first steps move an element whose
gradient is at rounding level by up to lr the other way), the sampled
volumes within 2e-5.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_dp_ranks as ranks

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli.distill import main as port_distill
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_autoencoder import main as port_train_ae
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import define_instance, load_json, preset_path
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.parallel.launch import RankPool, free_port
from ldm3d_torch.utils.nifti import read_nifti

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_tensorflow():
    with ranks.without_tensorflow():
        yield


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, threads=1, timeout_s=300) as p:
        yield p


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The micro preset's VAE and UNet with the port's seeded weights (the
    UNet's zero-init output conv drawn), as ``best`` checkpoints."""
    from types import SimpleNamespace

    cfg = load_json(preset_path("config_micro_cpu.json"))
    ns = SimpleNamespace(**cfg)
    gen = torch.Generator().manual_seed(1)
    ae = init_weights_(define_instance(ns, "autoencoder_def"), gen)
    unet = init_weights_(define_instance(ns, "diffusion_def"), gen)
    with torch.no_grad():
        unet.conv_out.weight.normal_(0.0, 0.05, generator=gen)
    return cfg, ae.state_dict(), unet.state_dict()


def _workdir(tmp_path, models, name, **train):
    cfg, ae_sd, u_sd = models
    cfg = json.loads(json.dumps(cfg))
    for section, values in train.items():
        cfg[section].update(values)
    (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
    model_dir = tmp_path / name / "ckpt"
    env = {"model_dir": str(model_dir), "output_dir": str(tmp_path / name / "out"),
           "tfevent_path": str(tmp_path / name / "tb"), "seed": 5, "synthetic_data": True,
           "synthetic_num": 8, "synthetic_shape": [16, 16, 16], "val_fraction": 0.5,
           "resume_ckpt": False}
    (tmp_path / f"{name}_env.json").write_text(json.dumps(env))
    CheckpointManager(str(model_dir), "autoencoder").save("best", {"state_dict": ae_sd})
    CheckpointManager(str(model_dir), "diffusion").save("best", {"state_dict": u_sd},
                                                        {"scale_factor": 0.9})
    return ["-c", str(tmp_path / f"{name}.json"), "-e", str(tmp_path / f"{name}_env.json"),
            "--device", "cpu"]


def _params_close(a: dict, b: dict, lr: float) -> None:
    assert a.keys() == b.keys()
    worst = max((a[k] - b[k]).abs().max().item() for k in a)
    assert worst <= 2 * lr + 1e-6, worst


def _ckpt(argv, name, role):
    env = json.loads(open(argv[3]).read())
    return CheckpointManager(env["model_dir"], name).load(role)


def test_train_diffusion_g2_launches_two_ranks_and_matches_g1(models, tmp_path):
    argv2 = _workdir(tmp_path, models, "g2", diffusion_train={"batch_size": 2, "max_epochs": 1})
    argv1 = _workdir(tmp_path, models, "g1", diffusion_train={"batch_size": 4, "max_epochs": 1})
    t2, t1 = {}, {}
    best2 = port_train(argv2 + ["-g", "2", "--no-images"], timings=t2)
    best1 = port_train(argv1 + ["-g", "1", "--no-images"], timings=t1)
    assert len(t2["diffusion_loss"]) == len(t1["diffusion_loss"]) == 1
    np.testing.assert_allclose(t2["diffusion_loss"], t1["diffusion_loss"], **TOL)
    np.testing.assert_allclose(t2["scale_factor"], t1["scale_factor"], **TOL)
    np.testing.assert_allclose(best2, best1, **TOL)
    _params_close(_ckpt(argv2, "diffusion", "last")["params"],
                  _ckpt(argv1, "diffusion", "last")["params"], LR)


def test_inference_g2_launches_two_ranks_and_matches_g1(models, tmp_path):
    """ddpm's ancestral step noises drawn for the global batch and sharded;
    rank 0 writes both volumes."""
    argv2 = _workdir(tmp_path, models, "s2")
    argv1 = _workdir(tmp_path, models, "s1")
    sample = ["--batch", "2", "--steps", "4", "--sampler", "ddpm"]
    paths2 = port_inference(argv2 + ["-g", "2"] + sample)
    paths1 = port_inference(argv1 + sample)
    assert len(paths2) == len(paths1) == 2
    assert sorted(os.listdir(tmp_path / "s2" / "out")) == sorted(os.path.basename(p) for p in paths2)
    for a, b in zip(sorted(paths2), sorted(paths1)):
        np.testing.assert_allclose(read_nifti(a)[0], read_nifti(b)[0], atol=2e-5, rtol=0)


def test_multihost_under_torchrun_samples_as_one_process(models, tmp_path):
    """``--multihost``: torchrun starts the two processes (one a rank, its
    environment the rendezvous), each joins the process group, and rank 0
    writes the volumes of one process's batch-2 sample."""
    argv2 = _workdir(tmp_path, models, "t2")
    argv1 = _workdir(tmp_path, models, "t1")
    sample = ["--batch", "2", "--steps", "4", "--sampler", "ddpm"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(sys.path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(free_port()), "-m", "ldm3d_torch.cli.inference", *argv2,
         "--multihost", *sample], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=240)
    finally:  # torchrun and its ranks, whatever happened
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-6000:]
    paths1 = port_inference(argv1 + sample)
    paths2 = sorted(str(p) for p in (tmp_path / "t2" / "out").glob("*.nii.gz"))
    assert len(paths2) == len(paths1) == 2
    for a, b in zip(paths2, sorted(paths1)):
        np.testing.assert_allclose(read_nifti(a)[0], read_nifti(b)[0], atol=2e-5, rtol=0)


def test_stage1_cli_on_two_ranks_matches_g1(pool, models, tmp_path):
    """A warm-up epoch, then an adversarial one (``warmup_epochs`` 0)."""
    kw = dict(max_epochs=2, warmup_epochs=0, perceptual_weight=0.0)
    argv2 = _workdir(tmp_path, models, "a2", autoencoder_train=dict(batch_size=2, **kw))
    argv1 = _workdir(tmp_path, models, "a1", autoencoder_train=dict(
        batch_size=4, lr=LR * 2 ** 0.5 * 0.5, **kw))
    out = pool.run(ranks.run_cli, "train_autoencoder", argv2 + ["-g", "2", "--no-images"])
    (best2, t2), (best2b, _) = out
    t1 = {}
    best1 = port_train_ae(argv1 + ["-g", "1", "--no-images"], timings=t1)
    assert t2["adv_active"] == t1["adv_active"] == [False, True]
    for name in ("g_loss", "recon_loss", "kl_loss", "adv_loss", "g_grad_norm", "d_loss"):
        np.testing.assert_allclose(t2[name], t1[name], err_msg=name, **TOL)
    np.testing.assert_allclose([best2, best2b], [best1, best1], **TOL)
    for name in ("autoencoder", "discriminator"):
        _params_close(_ckpt(argv2, name, "best")["state_dict"],
                      _ckpt(argv1, name, "best")["state_dict"], LR)


def test_distill_cli_on_two_ranks_matches_g1(pool, models, tmp_path):
    argv2 = _workdir(tmp_path, models, "d2", diffusion_train={"batch_size": 2})
    argv1 = _workdir(tmp_path, models, "d1", diffusion_train={"batch_size": 4})
    run = ["--teacher-steps", "4", "--rounds", "1", "--steps-per-round", "2", "--lr", "1e-3"]
    (_, t2), _ = pool.run(ranks.run_cli, "distill", argv2 + ["-g", "2"] + run)
    t1 = {}
    port_distill(argv1 + run, timings=t1)
    np.testing.assert_allclose(t2["distill_loss"], t1["distill_loss"], **TOL)
    np.testing.assert_allclose(t2["grad_norm"], t1["grad_norm"], **TOL)
    _params_close(_ckpt(argv2, "diffusion", "distilled")["state_dict"],
                  _ckpt(argv1, "diffusion", "distilled")["state_dict"], 1e-3)
