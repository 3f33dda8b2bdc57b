"""Typed config schema: key and type validation at load time.

The port's own copy of ``ldm3d_tpu/configs/schema.py``, with the same
schema and the same messages. The reference flattens config JSON onto the
argparse namespace with setattr and no validation
(``3d_ldm/train_autoencoder.py:120-126``): a misspelled key like
``"perceptul_weight"`` silently disables the perceptual loss and a config
key can silently shadow a CLI flag. Here:

  * every known key has an expected type (int/float/str/bool/list/dict);
  * unknown keys are an ERROR, with a did-you-mean suggestion;
  * ``*_def`` entries must be ``_target_`` dicts (their kwargs are validated
    by the registry constructor at instantiation, since ``@ref``/``$expr``
    values are not statically typed);
  * every bundled preset validates unchanged.
"""

from __future__ import annotations

import difflib
from typing import Any, Mapping

__all__ = ["validate_config", "validate_environment", "ConfigSchemaError",
           "CONFIG_SCHEMA", "ENVIRONMENT_SCHEMA"]


class ConfigSchemaError(ValueError):
    """A config file contains unknown keys or ill-typed values."""


_NUM = (int, float)
_BOOL = bool  # checked before int: bool is an int subclass


def _field(types, required=False):
    if not isinstance(types, tuple):
        types = (types,)
    return (types, required)


# training-section keys shared by both stages
_TRAIN_COMMON = {
    "batch_size": _field(int, required=True),
    "patch_size": _field(list, required=True),
    "lr": _field(_NUM, required=True),
    "max_epochs": _field(int, required=True),
    "val_interval": _field(int, required=True),
    "save_interval": _field(int),          # reference multigpu/stable presets
    "lr_scheduler": _field(str),           # "warmup_cosine" (ref §2.4.1: wired here)
}

AUTOENCODER_TRAIN_SCHEMA = {
    **_TRAIN_COMMON,
    "perceptual_weight": _field(_NUM, required=True),
    "kl_weight": _field(_NUM, required=True),
    "recon_loss": _field(str),
    "adv_weight": _field(_NUM),            # LSGAN weight (default 0.01)
    "warmup_epochs": _field(int),          # adversarial warm-up gate (ref :304)
}

DIFFUSION_TRAIN_SCHEMA = dict(_TRAIN_COMMON)

NOISE_SCHEDULER_SCHEMA = {
    "num_train_timesteps": _field(int, required=True),
    "beta_start": _field(_NUM, required=True),
    "beta_end": _field(_NUM, required=True),
    "schedule": _field(str),
    "prediction_type": _field(str),        # epsilon | sample | v_prediction
    "timestep_spacing": _field(str),       # leading (MONAI parity) | trailing | karras
}

# sentinel types for nested sections / _target_ dicts
_TARGET = object()

CONFIG_SCHEMA: dict[str, Any] = {
    "channel": _field(int),
    "spacing": _field(list),
    "spatial_dims": _field(int),
    "image_channels": _field(int, required=True),
    "latent_channels": _field(int, required=True),
    "autoencoder_def": _TARGET,
    "discriminator_def": _TARGET,
    "diffusion_def": _TARGET,
    "autoencoder_train": AUTOENCODER_TRAIN_SCHEMA,
    "diffusion_train": DIFFUSION_TRAIN_SCHEMA,
    "NoiseScheduler": NOISE_SCHEDULER_SCHEMA,
}

ENVIRONMENT_SCHEMA: dict[str, Any] = {
    "data_base_dir": _field(str),
    "model_dir": _field(str, required=True),
    "output_dir": _field(str),
    "tfevent_path": _field(str),
    "resume_ckpt": _field(_BOOL),
    "npz_dir": _field(str),
    "npz_dir_train": _field(str),
    "npz_dir_val": _field(str),
    "val_fraction": _field(_NUM),
    "seed": _field(int),
    "synthetic_data": _field(_BOOL),
    "synthetic_num": _field(int),
    "synthetic_shape": _field(list),
    "lpips_weights": _field(str),
}


def _type_name(types) -> str:
    return "/".join(t.__name__ for t in types)


def _check_value(path: str, value, types, problems: list[str]) -> None:
    # bool passes isinstance(int) — reject a bool where an int is expected
    if isinstance(value, bool) and bool not in types:
        problems.append(f"{path}: expected {_type_name(types)}, got bool")
        return
    if not isinstance(value, types):
        problems.append(
            f"{path}: expected {_type_name(types)}, got {type(value).__name__} ({value!r})")


def _suggest(key: str, known) -> str:
    close = difflib.get_close_matches(key, list(known), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def _check_section(name: str, section: Mapping[str, Any], schema: Mapping[str, Any],
                   problems: list[str]) -> None:
    if not isinstance(section, Mapping):
        problems.append(f"{name}: expected an object, got {type(section).__name__}")
        return
    for key, value in section.items():
        if key not in schema:
            problems.append(f"{name}.{key}: unknown key{_suggest(key, schema)}")
            continue
        types, _ = schema[key]
        # dialect escapes resolve later; skip static type check for them
        if isinstance(value, str) and value[:1] in ("@", "$"):
            continue
        _check_value(f"{name}.{key}", value, types, problems)
    for key, (types, required) in schema.items():
        if required and key not in section:
            problems.append(f"{name}.{key}: required key missing")


def validate_config(config: Mapping[str, Any], *, source: str = "config") -> None:
    """Validate a hardware-preset config dict; raise ConfigSchemaError listing
    every problem (unknown keys, type mismatches, missing required keys)."""
    problems: list[str] = []
    for key, value in config.items():
        if key not in CONFIG_SCHEMA:
            problems.append(f"{key}: unknown key{_suggest(key, CONFIG_SCHEMA)}")
            continue
        spec = CONFIG_SCHEMA[key]
        if spec is _TARGET:
            if not isinstance(value, Mapping) or "_target_" not in value:
                problems.append(f"{key}: expected a dict with a '_target_' entry")
        elif isinstance(spec, dict):
            _check_section(key, value, spec, problems)
        else:
            types, _ = spec
            if isinstance(value, str) and value[:1] in ("@", "$"):
                continue
            _check_value(key, value, types, problems)
    # required top-level keys only matter when the stage that needs them is
    # present; image/latent channels are needed by every entry point
    for key, spec in CONFIG_SCHEMA.items():
        if spec is _TARGET or isinstance(spec, dict):
            continue
        types, required = spec
        if required and key not in config:
            problems.append(f"{key}: required key missing")
    if problems:
        raise ConfigSchemaError(f"invalid {source}: " + "; ".join(problems))


def validate_environment(env: Mapping[str, Any], *, source: str = "environment") -> None:
    """Validate an environment.json dict (paths/seed/data flags)."""
    problems: list[str] = []
    for key, value in env.items():
        if key not in ENVIRONMENT_SCHEMA:
            problems.append(f"{key}: unknown key{_suggest(key, ENVIRONMENT_SCHEMA)}")
            continue
        types, _ = ENVIRONMENT_SCHEMA[key]
        _check_value(key, value, types, problems)
    for key, (types, required) in ENVIRONMENT_SCHEMA.items():
        if required and key not in env:
            problems.append(f"{key}: required key missing")
    if problems:
        raise ConfigSchemaError(f"invalid {source}: " + "; ".join(problems))
