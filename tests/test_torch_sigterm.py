"""The port's trainers hand the SIGTERM handler back on every way out.

Each trainer installs ``GracefulShutdown`` for its run. Whether ``main``
returns, exits 75 on a preemption or raises inside its loop, the handler
that was installed before it is the one installed after it; a handler left
behind would latch a later SIGTERM into a flag that nothing polls.
"""

import json
import os
import signal
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ldm3d_torch.cli.train_autoencoder as port_ta
import ldm3d_torch.cli.train_diffusion as port_td
from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.cli import common as port_common
from ldm3d_torch.configs import define_instance
from ldm3d_torch.nn import init_weights_
from ldm3d_torch.training import GracefulShutdown

torch.set_num_threads(1)

MICRO = os.path.join(os.path.dirname(port_common.__file__), "..", "configs", "presets",
                     "config_micro_cpu.json")


def _env(tmp_path) -> str:
    env = {"model_dir": str(tmp_path / "ckpt"), "output_dir": str(tmp_path / "out"),
           "tfevent_path": str(tmp_path / "tb"), "seed": 0, "synthetic_data": True,
           "synthetic_num": 6, "synthetic_shape": [16, 16, 16], "resume_ckpt": False,
           "val_fraction": 0.34}
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env))
    return str(path)


def _stage1_best(tmp_path) -> None:
    args = SimpleNamespace(**json.loads(Path(MICRO).read_text()))
    ae = init_weights_(define_instance(args, "autoencoder_def"),
                       torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "ckpt"), "autoencoder").save(
        "best", {"state_dict": ae.state_dict()})


class _StopOnSecondPoll(GracefulShutdown):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.polls = 0

    @property
    def requested_global(self) -> bool:
        self.polls += 1
        if self.polls == 2:
            self.trigger()
        return self.requested


class _StepFault(RuntimeError):
    pass


def _raising_on_second_call(make_step):
    def make(*a, **k):
        step = make_step(*a, **k)
        calls = []

        def run(*sa, **sk):
            calls.append(None)
            if len(calls) == 2:
                raise _StepFault("a step that fails mid-epoch")
            return step(*sa, **sk)

        return run

    return make


TRAINERS = {"stage1": (port_ta, "make_stage1_train_step"),
            "stage2": (port_td, "make_stage2_train_step")}


@pytest.mark.parametrize("outcome", ["returns", "exits_75", "raises"])
@pytest.mark.parametrize("trainer", ["stage1", "stage2"])
def test_trainer_restores_the_sigterm_handler(tmp_path, monkeypatch, trainer, outcome):
    module, step_factory = TRAINERS[trainer]
    if trainer == "stage2":
        _stage1_best(tmp_path)
    if outcome == "exits_75":
        monkeypatch.setattr(module, "GracefulShutdown", _StopOnSecondPoll)
    if outcome == "raises":
        monkeypatch.setattr(module, step_factory,
                            _raising_on_second_call(getattr(module, step_factory)))

    def before(signum, frame):  # the caller's own handler
        raise AssertionError("not delivered in this test")

    previous = signal.signal(signal.SIGTERM, before)
    try:
        argv = ["-c", MICRO, "-e", _env(tmp_path), "--device", "cpu", "--max-epochs", "1",
                "--no-images"]
        if outcome == "returns":
            assert np.isfinite(module.main(argv))
        elif outcome == "exits_75":
            with pytest.raises(SystemExit) as exc:
                module.main(argv)
            assert exc.value.code == 75
        else:
            with pytest.raises(_StepFault):
                module.main(argv)
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)
