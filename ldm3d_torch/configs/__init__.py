"""Config system: reference-dialect JSON resolver + bundled presets."""

import os

from ldm3d_torch.configs.registry import register
from ldm3d_torch.configs.resolver import (
    ConfigResolver,
    define_instance,
    load_json,
    resolve_config,
)

PRESET_DIR = os.path.join(os.path.dirname(__file__), "presets")


def preset_path(name: str) -> str:
    """Absolute path of a bundled preset, e.g. ``preset_path("config_train_32g.json")``."""
    return os.path.join(PRESET_DIR, name)


__all__ = [
    "ConfigResolver",
    "define_instance",
    "load_json",
    "resolve_config",
    "register",
    "preset_path",
    "PRESET_DIR",
]
