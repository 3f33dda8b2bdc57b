"""CLI config merging with reference parity.

The port's own copy of ``ldm3d_tpu/utils/config_merge.py``: the reference
flattens ``environment.json`` and ``config_train_*.json`` onto the argparse
namespace via ``setattr`` (reference ``3d_ldm/train_autoencoder.py:120-126``),
later files winning. The JAX package's typed schema validation
(``ldm3d_tpu/configs/schema.py``) is not ported in this slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


def merge_configs_onto_args(args: Any, environment_file: str, config_file: str) -> Any:
    """Merge env + config JSON files onto ``args`` (env < config)."""
    with open(environment_file, "r") as f:
        env_dict = json.load(f)
    with open(config_file, "r") as f:
        config_dict = json.load(f)
    for k, v in env_dict.items():
        setattr(args, k, v)
    for k, v in config_dict.items():
        setattr(args, k, v)
    if not hasattr(args, "output_dir"):  # optional in environment.json
        args.output_dir = "./output"
    return args


@dataclasses.dataclass
class TrainContext:
    """Resolved, typed view of the merged config."""

    args: Any

    def scheduler_config(self) -> dict:
        # presets may omit the NoiseScheduler block: DDPMScheduler defaults
        default = {"num_train_timesteps": 1000, "schedule": "scaled_linear_beta",
                   "beta_start": 0.0015, "beta_end": 0.0195,
                   "prediction_type": "epsilon"}
        cfg = getattr(self.args, "NoiseScheduler", None) or default
        return {**default, **cfg}
