"""A minimal environment file trains both stages, in the port as in JAX (C9).

Split from ``tests/test_torch_config.py``: an ``environment.json`` holding
only ``model_dir`` runs both JAX trainers, each in a subprocess of its own
(one host device), and both of the port's in this process while those run;
each writes its TensorBoard events under the default ``./runs``. The JAX
trainers' runs are the slowest part of the config tests, and take a test
process of their own.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import torch
from test_torch_models import ref_jit

from ldm3d_torch.configs import define_instance as port_define_instance
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_tpu.configs import ConfigResolver, load_json

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


# --- C9: a minimal environment file trains ------------------------------------

def _run(module: str, cwd: Path, *flags) -> subprocess.Popen:
    # one host device (the suite's conftest forces 8 virtual ones); XLA's
    # cheaper codegen (the JAX trainers' short runs are compile-bound; their
    # losses come out the same) and the suite's compile cache, not ~/.cache
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_backend_optimization_level=0 "
                         "--xla_llvm_disable_expensive_passes=true",
               JAX_COMPILATION_CACHE_DIR=jax.config.jax_compilation_cache_dir or "",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    cmd = [sys.executable, "-m", module, "-c", str(cwd / "config.json"), "-e",
           str(cwd / "env.json"), "--synthetic-data", "--max-epochs", "1", "--no-images", *flags]
    with open(cwd / "trainer.log", "w") as log:  # a file: a pipe left unread could fill
        return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)


def _stage2_ready_dir(path: Path, jax_side: bool) -> Path:
    """A directory holding the micro preset, an environment of ``model_dir``
    alone, and a stage-1 ``best`` autoencoder for the stage-2 trainer."""
    path.mkdir()
    (path / "config.json").write_text(
        Path(port_preset_path("config_micro_cpu.json")).read_text())
    (path / "env.json").write_text(json.dumps({"model_dir": "m"}))
    cfg = load_json(port_preset_path("config_micro_cpu.json"))
    if jax_side:
        from ldm3d_tpu.ckpt import CheckpointManager, StageArtifacts

        ae = ConfigResolver(cfg).instantiate("autoencoder_def")
        key = jax.random.PRNGKey(0)
        params = ref_jit(ae.init)({"params": key, "sample": key},
                                  jnp.zeros((1, 16, 16, 16, 1)))["params"]
        CheckpointManager(str(path / "m"), StageArtifacts.AUTOENCODER).save(
            "best", {"params": params})
    else:
        from ldm3d_torch.ckpt import CheckpointManager

        with torch.device("cpu"):
            ae = port_define_instance(SimpleNamespace(**cfg), "autoencoder_def")
        CheckpointManager(str(path / "m"), "autoencoder").save(
            "best", {"state_dict": ae.state_dict()})
    return path


def _stage1_dir(path: Path) -> Path:
    """A directory holding the micro preset and an environment of
    ``model_dir`` alone."""
    path.mkdir()
    (path / "config.json").write_text(
        Path(port_preset_path("config_micro_cpu.json")).read_text())
    (path / "env.json").write_text(json.dumps({"model_dir": "m"}))
    return path


def test_minimal_environment_trains_both_stages_as_in_jax(tmp_path, monkeypatch, caplog):
    """``environment.json`` holding only ``model_dir``: the JAX trainers run
    (their merge defaults ``resume_ckpt``, ``tfevent_path`` and
    ``output_dir``), and so do the port's, writing their TensorBoard events
    under the default ``./runs``."""
    from ldm3d_torch.cli.train_autoencoder import main as port_train_autoencoder
    from ldm3d_torch.cli.train_diffusion import main as port_train_diffusion

    dirs = {}
    for side in ("jax", "port"):
        dirs[(side, "train_autoencoder")] = _stage1_dir(tmp_path / f"{side}_stage1")
        dirs[(side, "train_diffusion")] = _stage2_ready_dir(tmp_path / f"{side}_stage2",
                                                            jax_side=side == "jax")
    jax_runs = {cli: _run(f"ldm3d_tpu.cli.{cli}", dirs[("jax", cli)])
                for cli in ("train_autoencoder", "train_diffusion")}
    try:
        for cli, main in (("train_autoencoder", port_train_autoencoder),
                          ("train_diffusion", port_train_diffusion)):
            cwd = dirs[("port", cli)]
            monkeypatch.chdir(cwd)
            caplog.clear()
            with caplog.at_level(logging.INFO):
                main(["-c", "config.json", "-e", "env.json", "--synthetic-data",
                      "--max-epochs", "1", "--no-images", "--device", "cpu"])
            assert any("training complete" in r.getMessage() for r in caplog.records), \
                f"port {cli}: {[r.getMessage() for r in caplog.records][-20:]}"
            assert (cwd / "runs").is_dir(), f"port {cli} wrote no ./runs"
    finally:
        for proc in jax_runs.values():
            proc.wait(timeout=900)
    for cli, proc in jax_runs.items():
        out = (dirs[("jax", cli)] / "trainer.log").read_text()
        assert proc.returncode == 0, f"jax {cli} failed:\n{out[-3000:]}"
        assert "training complete" in out, f"jax {cli}:\n{out[-2000:]}"
        assert (dirs[("jax", cli)] / "runs").is_dir(), f"jax {cli} wrote no ./runs"
    for cli, files in (("train_autoencoder", ("autoencoder_best.pt", "discriminator_best.pt")),
                       ("train_diffusion", ("diffusion_best.pt", "diffusion_last.pt"))):
        model_dir = dirs[("port", cli)] / "m"
        assert all((model_dir / f).is_file() for f in files), sorted(os.listdir(model_dir))
