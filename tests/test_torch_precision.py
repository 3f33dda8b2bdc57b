"""The entry points pin the port's fp32 precision (fault C3).

PyTorch runs fp32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), while the port's fp32 is full
fp32: its limits and records are of full fp32 arithmetic. So every entry
point of a main path sets both ``allow_tf32`` flags to False before any work
(``ldm3d_torch.cli.common.pin_fp32_precision``). Each test sets both flags
True first, runs an entry point on the CPU on the tiny preset, and finds
both False after it; the flags are restored after each test.
"""

import json

import pytest
import torch
from test_torch_serving import port_two_stage

from ldm3d_torch.cli.common import tf32_flags
from ldm3d_torch.serving.model_server import ModelServer


@pytest.fixture
def tf32_on():
    """Both flags True for the test, and back to what they were after it."""
    with tf32_flags(True):
        yield


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def test_tf32_flags_sets_and_restores_both():
    before = _flags()
    with tf32_flags(True):
        assert _flags() == (True, True)
        with tf32_flags(False):
            assert _flags() == (False, False)
        assert _flags() == (True, True)
    assert _flags() == before


def test_model_server_load_pins_full_fp32(tmp_path, tf32_on):
    cfg, env = port_two_stage(tmp_path)
    server = ModelServer(cfg, env, sampler="ddim", steps=2, device="cpu")
    assert _flags() == (True, True)
    server.load_model()
    assert not server.is_dummy
    assert _flags() == (False, False)


def _synthetic_two_stage(root):
    """``port_two_stage``'s checkpoints, with an environment of synthetic
    32^3 pairs for the CLIs."""
    cfg, env = port_two_stage(root)
    settings = json.loads(open(env).read())
    settings.update(tfevent_path=str(root / "tb"), synthetic_data=True, synthetic_num=3,
                    synthetic_shape=[32, 32, 32], resume_ckpt=False)
    open(env, "w").write(json.dumps(settings))
    return cfg, env


def test_inference_cli_pins_full_fp32(tmp_path, tf32_on):
    from ldm3d_torch.cli.inference import main

    cfg, env = _synthetic_two_stage(tmp_path)
    written = main(["-c", cfg, "-e", env, "--device", "cpu", "-n", "1", "--sampler", "ddim",
                    "--steps", "2"])
    assert len(written) == 1
    assert _flags() == (False, False)


def test_train_cli_pins_full_fp32(tmp_path, tf32_on):
    from ldm3d_torch.cli.train_diffusion import main

    cfg, env = _synthetic_two_stage(tmp_path)
    best = main(["-c", cfg, "-e", env, "--device", "cpu", "--max-epochs", "1", "--no-images"])
    assert best == best  # not NaN
    assert _flags() == (False, False)
