"""CLI config merging with reference parity.

The port's own copy of ``ldm3d_tpu/utils/config_merge.py``: the reference
flattens ``environment.json`` and ``config_train_*.json`` onto the argparse
namespace via ``setattr`` (reference ``3d_ldm/train_autoencoder.py:120-126``),
later files winning. Both files are validated against the typed schema
(:mod:`ldm3d_torch.configs.schema`) first, and the optional environment keys
get the JAX package's defaults.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# optional environment keys the CLIs read as plain attributes, and their
# defaults when environment.json omits them (as the JAX merge sets them)
OPTIONAL_ENV_DEFAULTS = (("resume_ckpt", False), ("tfevent_path", "./runs"),
                         ("output_dir", "./output"))


def merge_configs_onto_args(args: Any, environment_file: str, config_file: str,
                            validate: bool = True) -> Any:
    """Merge env + config JSON files onto ``args`` (attributes win: env < config).

    Both files are validated against the typed schema BEFORE merging:
    unknown keys and type mismatches raise ``ConfigSchemaError``, so a
    misspelled key can never silently disable a loss term or shadow a CLI
    flag. A minimal environment file (just ``model_dir``) runs: the optional
    keys get :data:`OPTIONAL_ENV_DEFAULTS`."""
    with open(environment_file, "r") as f:
        env_dict = json.load(f)
    with open(config_file, "r") as f:
        config_dict = json.load(f)
    if validate:
        from ldm3d_torch.configs.schema import validate_config, validate_environment

        validate_environment(env_dict, source=environment_file)
        validate_config(config_dict, source=config_file)
    for k, v in env_dict.items():
        setattr(args, k, v)
    for k, v in config_dict.items():
        setattr(args, k, v)
    for k, default in OPTIONAL_ENV_DEFAULTS:
        if not hasattr(args, k):
            setattr(args, k, default)
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
