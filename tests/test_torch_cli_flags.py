"""Every flag of the JAX package's CLI parser (``ldm3d_tpu/cli/common.py``
``build_parser``) parses in the port's two CLIs.

One case per flag per CLI: the CLI runs with ``--device cpu`` on the tiny
preset and an empty model directory. A flag whose path the port runs goes on
to the checkpoint load, which raises ``FileNotFoundError`` there (the point
past the parser, the flag checks, the config merge and, in training, the
data loaders); a flag whose path is not ported raises
``NotImplementedError`` naming its ROADMAP item.
"""

import json

import pytest

from ldm3d_torch.cli.inference import main as port_inference
from ldm3d_torch.cli.train_diffusion import main as port_train
from ldm3d_torch.configs import preset_path

PARALLEL = "'Parallelism'"
PIPELINE = "'UNet mid_depth stack, then pipeline parallelism'"
FOLLOW_UPS = "'Stage-2 training follow-ups'"

# (argv, None if the flag runs, else the ROADMAP item its error names)
FLAGS = {
    "-g": [(["-g", "0"], None), (["-g", "1"], None), (["-g", "2"], PARALLEL)],
    "--gpus": [(["--gpus", "1"], None)],
    "--amp": [(["--amp"], None)],
    "--compile": [(["--compile"], None)],
    "--profile": [(["--profile"], FOLLOW_UPS)],
    "--no-images": [(["--no-images"], None)],
    "--max-epochs": [(["--max-epochs", "1"], None)],
    "--synthetic-data": [(["--synthetic-data"], None)],
    "--track": [(["--track"], FOLLOW_UPS)],
    "--experiment": [(["--experiment", "port-run"], None)],
    "--debug-nans": [(["--debug-nans"], FOLLOW_UPS)],
    "--grad-accum": [(["--grad-accum", "2"], FOLLOW_UPS)],
    "--remat": [(["--remat"], FOLLOW_UPS)],
    "--spatial": [(["--spatial", "2"], PARALLEL)],
    "--ema-decay": [(["--ema-decay", "0.9"], None)],
    "--multihost": [(["--multihost"], PARALLEL)],
    "--tensor": [(["--tensor", "2"], PARALLEL)],
    "--zero": [(["--zero"], PARALLEL)],
    "--fsdp": [(["--fsdp"], PARALLEL)],
    "--pipeline": [(["--pipeline", "2"], PIPELINE)],
    "--pipeline-microbatches": [(["--pipeline-microbatches", "2"], PIPELINE)],
}
CASES = [(flag, argv, item) for flag, cases in FLAGS.items() for argv, item in cases]
CLIS = {"inference": port_inference, "train_diffusion": port_train}


def test_cases_cover_every_flag_of_the_jax_parser():
    from ldm3d_tpu.cli.common import build_parser

    jax_flags = {opt for action in build_parser("x")._actions for opt in action.option_strings}
    assert jax_flags - {"-h", "--help", "-e", "--environment-file", "-c",
                        "--config-file"} == set(FLAGS)


@pytest.fixture
def env_file(tmp_path):
    env = {"model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"),
           "tfevent_path": str(tmp_path / "tb"), "seed": 0, "synthetic_data": True,
           "synthetic_num": 2, "synthetic_shape": [32, 32, 32], "resume_ckpt": False}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


@pytest.mark.parametrize("cli", sorted(CLIS))
@pytest.mark.parametrize("flag,argv,item", CASES,
                         ids=[" ".join(argv) for _, argv, _ in CASES])
def test_jax_flag_parses_then_runs_or_names_its_item(cli, flag, argv, item, env_file):
    args = ["-c", preset_path("config_tiny_cpu.json"), "-e", env_file, "--device", "cpu", *argv]
    if item is None:
        with pytest.raises(FileNotFoundError, match="checkpoint|No such file"):
            CLIS[cli](args)
    else:
        with pytest.raises(NotImplementedError, match=f"^{flag if flag != '-g' else '--gpus'} "
                                                      f".*ROADMAP.md queue A, {item}"):
            CLIS[cli](args)
