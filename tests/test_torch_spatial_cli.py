"""``--spatial`` in the port's CLIs.

* ``validate_spatial_divisibility`` raises what the JAX function raises,
  with its text (among the cases, 32g's 80^3 patch at S = 2 with its four
  downsamples, and multigpu's 64^3, which passes);
* the refusals, in one process: the stage-1 trainer and ``cli.evaluate``
  name the ROADMAP item, distillation raises the JAX CLI's ``ValueError``,
  ``--spatial`` with ``--zero``, ``--fsdp`` or ``--tensor`` names the
  ROADMAP item, and too few ranks for the axes raise JAX's ``ValueError``;
* on the 2 ranks of one ``RankPool`` (gloo; ``tests/torch_dp_ranks.py``
  ``run_cli``): ``--cache-latents`` with ``--spatial 2`` raises JAX's
  ``ValueError``; ``cli.train_diffusion -g 2 --spatial 2`` trains an epoch
  of the micro preset at 32^3 (its periodic sample through the spatial
  encoder and sampler), its losses those of the one-process run of the
  same global batch within atol 2e-5 and rtol 2e-5, writes its checkpoints
  once, and its ``last`` resumes at world 1; ``cli.inference -g 2
  --spatial 2`` writes the one-process volumes of the same checkpoint and
  seed, once, within 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch_dp_ranks as ranks

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli.distill import main as port_distill
from ldm3d_torch.cli.evaluate import main as port_evaluate
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_autoencoder import main as port_train_ae
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import load_json, preset_path
from ldm3d_torch.parallel.launch import RankPool
from ldm3d_torch.parallel.spatial import validate_spatial_divisibility
from ldm3d_torch.utils.nifti import read_nifti

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
PARALLEL = "ROADMAP.md queue A, 'Parallelism'"


@pytest.fixture(scope="module", autouse=True)
def _no_tensorflow():
    with ranks.without_tensorflow():
        yield


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, threads=1, timeout_s=300) as p:
        yield p


@pytest.mark.parametrize("depth,n,downsamples", [
    (64, 2, 4),   # multigpu's patch, its VAE's 2 and its UNet's 2 downsamples
    (80, 2, 4),   # 32g's patch: 80 / 2 = 40 -> 20 -> 10 -> 5, odd before the 4th
    (63, 2, 4),   # not divisible at all
    (16, 2, 4),   # the micro preset's own 16^3
    (32, 4, 3),
    (8, 1, 3),
])
def test_divisibility_raises_what_jax_raises(depth, n, downsamples):
    from ldm3d_tpu.parallel import validate_spatial_divisibility as jax_validate

    def outcome(fn):
        try:
            fn(depth, n, downsamples)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jax_validate)
    assert outcome(validate_spatial_divisibility) == want
    assert (want is None) == ((depth, n) in ((64, 2), (32, 4), (8, 1)))


def _env(tmp_path, name: str = "run", **extra) -> str:
    env = {"model_dir": str(tmp_path / name / "ckpt"), "output_dir": str(tmp_path / name / "out"),
           "tfevent_path": str(tmp_path / name / "tb"), "seed": 2, "synthetic_data": True,
           "synthetic_num": 4, "synthetic_shape": [32, 32, 32], "val_fraction": 0.5,
           "resume_ckpt": False, **extra}
    path = tmp_path / f"{name}_env.json"
    path.write_text(json.dumps(env))
    return str(path)


@pytest.mark.parametrize("cli,flags,error,match", [
    (port_train_ae, ["--spatial", "2"], NotImplementedError, f"^--spatial 2 .*{PARALLEL}"),
    (port_evaluate, ["--spatial", "2"], NotImplementedError, f"^--spatial 2 .*{PARALLEL}"),
    (port_distill, ["--spatial", "2"], ValueError, "^distillation runs data-parallel"),
    (port_train, ["--spatial", "2", "--zero"], NotImplementedError, f"--zero .*{PARALLEL}"),
    (port_train, ["--spatial", "2", "--fsdp"], NotImplementedError, f"--fsdp .*{PARALLEL}"),
    (port_train, ["--spatial", "2", "--tensor", "2"], NotImplementedError,
     f"--tensor .*{PARALLEL}"),
    (port_inference, ["--spatial", "2", "--fsdp"], NotImplementedError,
     f"--fsdp .*{PARALLEL}"),
    (port_inference, ["--spatial", "4", "-g", "2"], ValueError,
     "^--spatial 4 x --tensor 1 x --pipeline 1 does not divide 2 devices"),
], ids=["stage1", "evaluate", "distill", "zero", "fsdp", "tensor", "inference_fsdp",
        "too_few_ranks"])
def test_spatial_refusals(cli, flags, error, match, tmp_path, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    argv = ["-c", preset_path("config_micro_cpu.json"), "-e", _env(tmp_path), "--device",
            "cpu", *flags]
    with pytest.raises(error, match=match):
        cli(argv)


def _micro_run(tmp_path, name: str, batch: int = 1):
    """The micro preset at a 32^3 patch with ``batch`` a replica, one epoch,
    and a seeded stage-1 VAE as ``autoencoder_best``."""
    from types import SimpleNamespace

    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import init_weights_

    cfg = load_json(preset_path("config_micro_cpu.json"))
    cfg["diffusion_train"].update(batch_size=batch, max_epochs=1, patch_size=[32, 32, 32])
    cfg_path = tmp_path / f"{name}.json"
    cfg_path.write_text(json.dumps(cfg))
    env = _env(tmp_path, name)
    ae = init_weights_(define_instance(SimpleNamespace(**cfg), "autoencoder_def"),
                       torch.Generator().manual_seed(4))
    CheckpointManager(str(tmp_path / name / "ckpt"), "autoencoder").save(
        "best", {"state_dict": ae.state_dict()})
    return ["-c", str(cfg_path), "-e", env, "--device", "cpu"]


def test_cache_latents_with_spatial_is_refused(pool, tmp_path):
    argv = _micro_run(tmp_path, "cache")
    with pytest.raises(ValueError, match="^--cache-latents is incompatible with --spatial"):
        pool.run(ranks.run_cli, "train_diffusion",
                 argv + ["-g", "2", "--spatial", "2", "--cache-latents"])


def _resume(argv: list) -> list:
    env = json.loads(open(argv[3]).read())
    env["resume_ckpt"] = True
    open(argv[3], "w").write(json.dumps(env))
    return argv + ["--max-epochs", "2"]


def test_spatial_training_and_sampling_clis_on_two_ranks(pool, tmp_path):
    argv2 = _micro_run(tmp_path, "sp")
    two = pool.run(ranks.run_cli, "train_diffusion", argv2 + ["-g", "2", "--spatial", "2"])
    argv1 = _micro_run(tmp_path, "one")
    one_t: dict = {}
    port_train(argv1 + ["--no-images"], timings=one_t)
    (best2, t2), (best2b, _) = two
    assert best2 == best2b  # every rank validates the same number
    assert len(t2["diffusion_loss"]) == len(one_t["diffusion_loss"]) == 2
    np.testing.assert_allclose(t2["diffusion_loss"], one_t["diffusion_loss"], **TOL)
    one_best = CheckpointManager(str(tmp_path / "one" / "ckpt"), "diffusion").load_meta("best")
    np.testing.assert_allclose(best2, one_best["val_loss"], **TOL)
    mgr = CheckpointManager(str(tmp_path / "sp" / "ckpt"), "diffusion")
    assert mgr.load("last")["step"] == 2 and mgr.load_meta("best")["epoch"] == 0

    # the spatial run's 'last' resumes in one process
    resumed: dict = {}
    port_train(_resume(argv2) + ["--no-images"], timings=resumed)
    assert len(resumed["diffusion_loss"]) == 2
    assert mgr.load("last")["step"] == 4 and mgr.load_meta("last")["epoch"] == 1

    # sampling from that checkpoint: 2 ranks x 2 slabs against one process
    sample = ["--sampler", "ddim", "--steps", "3", "--batch", "1"]
    paths2 = pool.run(ranks.run_cli, "inference", argv2 + sample + ["-g", "2", "--spatial", "2"])
    written2 = paths2[0][0]
    assert paths2[1][0] == [] and len(written2) == 1
    out_dir = tmp_path / "sp" / "out"
    assert len(os.listdir(out_dir)) == 1  # written once
    written1 = port_inference(argv2 + sample)
    a, b = read_nifti(written2[0])[0], read_nifti(written1[0])[0]
    assert a.shape == b.shape == (32, 32, 32) and np.abs(b).max() > 0
    np.testing.assert_allclose(a, b, atol=1e-4)
