"""The port's stage-2 step at the JAX package's width-pathology widths
(ROADMAP C0, ``tests/test_stage2_width_regression.py``).

Split from ``tests/test_torch_train.py``, whose other tests share its
module's JAX models: these two train the port alone, 40 latents steps each,
and take a test process of their own.
"""

import numpy as np
import pytest
import torch

from ldm3d_torch.diffusion import DDPMScheduler as PortDDPM
from ldm3d_torch.nn import DiffusionUNet3D, init_weights_
from ldm3d_torch.training import (
    Stage2Config,
    TrainState,
    build_lr_schedule,
    make_diffusion_optimizer,
    make_stage2_train_step_latents,
)

torch.set_num_threads(1)


# --- ROADMAP C0: the width pathology (tests/test_stage2_width_regression.py) --------

def _final_loss(channels, steps=40, batch=2):
    """The JAX regression test's configuration on the port: 40 latents steps
    at lr 1e-3, the mean loss of the last 5."""
    unet = DiffusionUNet3D.from_config(
        spatial_dims=3, in_channels=8, out_channels=4, channels=channels,
        attention_levels=[False, True, True], num_head_channels=[0, 8, 8],
        num_res_blocks=1, norm_num_groups=8)
    init_weights_(unet, torch.Generator().manual_seed(0))
    lat = (8, 8, 8)
    state = TrainState(unet, make_diffusion_optimizer(
        unet.parameters(), build_lr_schedule("multistep", 1e-3, 100, 28)))
    step = make_stage2_train_step_latents(unet, PortDDPM.create(num_train_timesteps=1000),
                                          Stage2Config(conditional=True))
    mu = torch.from_numpy(np.random.default_rng(0).standard_normal((batch, *lat, 4),
                                                                   dtype=np.float32))
    sig = torch.full(mu.shape, 0.1)
    tb = {"label_mu": mu, "label_sigma": sig, "image_mu": mu * 0.5, "image_sigma": sig}
    gen = torch.Generator().manual_seed(0)
    last = []
    for i in range(steps):
        m = step(state, tb, 1.0, gen)
        if i >= steps - 5:
            last.append(float(m["diffusion_loss"]))
    return sum(last) / len(last)


def test_stage2_learns_at_tiny_width():
    """Guards the port's step/optimizer machinery: tiny widths must clearly
    descend from the zero-prediction plateau (1.0) within 40 steps."""
    assert _final_loss([16, 32, 32]) < 0.92


@pytest.mark.xfail(
    reason="mirrors the JAX package's open round-5 bug (widths >= 64 sit at the "
    "zero-prediction plateau, docs/artifacts/stage2_width_pathology_r5.json); ROADMAP C0 "
    "records what the port's step does here",
    strict=False,
)
def test_stage2_learns_at_mid_width():
    assert _final_loss([64, 128, 256]) < 0.92
