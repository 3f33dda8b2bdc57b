"""Every flag of the JAX package's CLI parser (``ldm3d_tpu/cli/common.py``
``build_parser``) parses in the port's five CLIs.

One case per flag per CLI: the CLI runs with ``--device cpu`` on the tiny
preset and an empty model directory. A flag whose path the port runs goes on
to the checkpoint load, which raises ``FileNotFoundError`` there (the point
past the parser, the flag checks, the config merge and, in training, the
data loaders); the stage-1 trainer loads no checkpoint, and goes on to its
LPIPS weights, which the environment sets to a missing file. A flag whose
path is not ported raises ``NotImplementedError`` naming its ROADMAP item,
``--pipeline`` in the stage-1 trainer the JAX CLI's ``ValueError``, and
``--pipeline``, ``--spatial`` and ``--tensor`` in the distillation CLI the
JAX CLI's ``ValueError`` (distillation runs data-parallel). ``--spatial 2``
runs in the stage-2 trainer and the sampler: in one process it raises the
JAX CLI's ``ValueError`` that the axes do not divide the devices.

``-g 2`` starts two CPU ranks (gloo), and each rank reaches the same point
past the flags: the launcher raises the ranks' ``FileNotFoundError`` (the
environment's 8 synthetic pairs, a quarter of them for validation, give
each rank its share of both splits). ``--multihost`` without torchrun's
environment raises ``RuntimeError``. The evaluate CLI has no data-parallel
path: there both name the ROADMAP item.
"""

import json

import pytest
import torch

from ldm3d_torch.cli.distill import main as port_distill
from ldm3d_torch.cli.evaluate import main as port_evaluate
from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_autoencoder import main as port_train_ae
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import preset_path

torch.set_num_threads(1)

PARALLEL = "'Parallelism'"
PIPELINE = "'UNet mid_depth stack, then pipeline parallelism'"

RANKS, TORCHRUN = "runs on 2 ranks", "needs torchrun"
ONE_DEVICE = {"evaluate"}  # CLIs without a data-parallel path
SPATIAL = {"inference", "train_diffusion"}  # CLIs that run --spatial

# (argv, None if the flag runs, else the ROADMAP item its error names, or
# RANKS / TORCHRUN)
FLAGS = {
    "-g": [(["-g", "0"], None), (["-g", "1"], None), (["-g", "2"], RANKS)],
    "--gpus": [(["--gpus", "1"], None)],
    "--amp": [(["--amp"], None)],
    "--compile": [(["--compile"], None)],
    "--profile": [(["--profile"], None)],
    "--no-images": [(["--no-images"], None)],
    "--max-epochs": [(["--max-epochs", "1"], None)],
    "--synthetic-data": [(["--synthetic-data"], None)],
    "--track": [(["--track"], None)],
    "--experiment": [(["--experiment", "port-run"], None)],
    "--debug-nans": [(["--debug-nans"], None)],
    "--grad-accum": [(["--grad-accum", "2"], None)],
    "--remat": [(["--remat"], None), (["--remat", "convs"], None)],
    "--spatial": [(["--spatial", "2"], PARALLEL)],
    "--ema-decay": [(["--ema-decay", "0.9"], None)],
    "--multihost": [(["--multihost"], TORCHRUN)],
    "--tensor": [(["--tensor", "2"], PARALLEL)],
    "--zero": [(["--zero"], None)],
    "--fsdp": [(["--fsdp"], None)],
    "--pipeline": [(["--pipeline", "2"], PIPELINE)],
    "--pipeline-microbatches": [(["--pipeline-microbatches", "2"], PIPELINE)],
}
CASES = [(flag, argv, item) for flag, cases in FLAGS.items() for argv, item in cases]
CLIS = {"inference": port_inference, "train_diffusion": port_train,
        "train_autoencoder": port_train_ae, "distill": port_distill, "evaluate": port_evaluate}


def test_cases_cover_every_flag_of_the_jax_parser():
    from ldm3d_tpu.cli.common import build_parser

    jax_flags = {opt for action in build_parser("x")._actions for opt in action.option_strings}
    assert jax_flags - {"-h", "--help", "-e", "--environment-file", "-c",
                        "--config-file"} == set(FLAGS)


@pytest.fixture
def env_file(tmp_path):
    env = {"model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"),
           "tfevent_path": str(tmp_path / "tb"), "seed": 0, "synthetic_data": True,
           "synthetic_num": 8, "val_fraction": 0.25, "synthetic_shape": [32, 32, 32],
           "resume_ckpt": False,
           "lpips_weights": str(tmp_path / "missing_lpips.pt")}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


@pytest.mark.parametrize("cli", sorted(CLIS))
@pytest.mark.parametrize("flag,argv,item", CASES,
                         ids=[" ".join(argv) for _, argv, _ in CASES])
def test_jax_flag_parses_then_runs_or_names_its_item(cli, flag, argv, item, env_file,
                                                      monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    args = ["-c", preset_path("config_tiny_cpu.json"), "-e", env_file, "--device", "cpu", *argv]
    if item in (RANKS, TORCHRUN):
        item = PARALLEL if cli in ONE_DEVICE else (None if item == RANKS else item)
    if item == TORCHRUN:
        with pytest.raises(RuntimeError, match="^--multihost needs torchrun's environment"):
            CLIS[cli](args)
    elif cli == "train_autoencoder" and flag == "--pipeline":
        with pytest.raises(ValueError, match="^--pipeline applies to stage 2"):
            CLIS[cli](args)
    elif cli == "distill" and flag in ("--pipeline", "--spatial", "--tensor"):
        with pytest.raises(ValueError, match="^distillation runs data-parallel"):
            CLIS[cli](args)
    elif cli in SPATIAL and flag == "--spatial":
        with pytest.raises(ValueError, match="^--spatial 2 x --tensor 1 x --pipeline 1 does "
                                             "not divide 1 devices"):
            CLIS[cli](args)
    elif item is None:
        with pytest.raises(FileNotFoundError, match="checkpoint|No such file|lpips_weights"):
            CLIS[cli](args)
    else:
        with pytest.raises(NotImplementedError, match=f"^{flag if flag != '-g' else '--gpus'} "
                                                      f".*ROADMAP.md queue A, {item}"):
            CLIS[cli](args)
