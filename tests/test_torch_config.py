"""Parity of the port's config layer with the JAX package.

* ``configs.schema``: every bundled preset and environment file validates in
  both packages, and each broken config or environment is rejected by both
  with the same ``ConfigSchemaError`` message, did-you-mean included.
* ``utils.config_merge``: the attributes the port's merge sets equal the JAX
  merge's, the optional environment keys' defaults among them (C9; that a
  minimal environment file, ``model_dir`` alone, trains with both trainers
  of both packages is ``tests/test_torch_config_minimal_env.py``).
* ``resolve_config`` and ``register``.
* Every preset builds in the port (on the meta device) with the JAX models'
  parameter counts (``jax.eval_shape`` of their init).
"""

import argparse
import copy
import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from ldm3d_torch.configs import define_instance as port_define_instance
from ldm3d_torch.configs import preset_path as port_preset_path
from ldm3d_torch.configs import register as port_register
from ldm3d_torch.configs import resolve_config as port_resolve_config
from ldm3d_torch.configs import schema as port_schema
from ldm3d_torch.configs.registry import _EXTRA as PORT_EXTRA
from ldm3d_torch.utils import merge_configs_onto_args as port_merge
from ldm3d_tpu.configs import ConfigResolver, load_json, preset_path
from ldm3d_tpu.configs import register as jax_register
from ldm3d_tpu.configs import resolve_config as jax_resolve_config
from ldm3d_tpu.configs import schema as jax_schema
from ldm3d_tpu.configs.registry import _EXTRA as JAX_EXTRA
from ldm3d_tpu.utils import merge_configs_onto_args as jax_merge

CONFIGS = ("config_micro_cpu.json", "config_tiny_cpu.json", "config_train_16g.json",
           "config_train_32g.json", "config_train_multigpu.json", "config_train_pp.json",
           "config_train_stable.json")

torch.set_num_threads(1)


def _outcome(validate, schema, value):
    """``None`` when ``value`` validates, else the error's class name and text."""
    try:
        getattr(schema, validate)(value, source="f.json")
    except schema.ConfigSchemaError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name", CONFIGS + ("environment.json",))
def test_every_preset_validates_in_both_packages(name):
    validate = "validate_environment" if name == "environment.json" else "validate_config"
    value = load_json(port_preset_path(name))
    assert _outcome(validate, port_schema, value) is None
    assert _outcome(validate, jax_schema, value) is None


def _broken_config(edit):
    cfg = copy.deepcopy(load_json(preset_path("config_train_32g.json")))
    edit(cfg)
    return cfg


BROKEN = {
    "misspelled_loss_weight": ("validate_config", lambda: _broken_config(
        lambda c: c["autoencoder_train"].update(perceptul_weight=c["autoencoder_train"].pop(
            "perceptual_weight")))),
    "wrong_type": ("validate_config", lambda: _broken_config(
        lambda c: c.update(latent_channels="16"))),
    "bool_for_int": ("validate_config", lambda: _broken_config(
        lambda c: c.update(image_channels=True))),
    "def_without_target": ("validate_config", lambda: _broken_config(
        lambda c: c["diffusion_def"].pop("_target_"))),
    "unknown_top_level_key": ("validate_config", lambda: _broken_config(
        lambda c: c.update(difusion_train=c.pop("diffusion_train")))),
    "missing_required": ("validate_config", lambda: _broken_config(
        lambda c: c.pop("image_channels"))),
    "scheduler_missing_key": ("validate_config", lambda: _broken_config(
        lambda c: c["NoiseScheduler"].pop("beta_end"))),
    "section_not_an_object": ("validate_config", lambda: _broken_config(
        lambda c: c.update(diffusion_train=[1, 2]))),
    "unknown_env_key": ("validate_environment", lambda: {"model_dir": "m",
                                                         "tfevents_path": "runs"}),
    "env_missing_model_dir": ("validate_environment", lambda: {"output_dir": "out"}),
    "env_str_for_bool": ("validate_environment", lambda: {"model_dir": "m",
                                                          "resume_ckpt": "yes"}),
    "env_several_problems": ("validate_environment", lambda: {"model_dr": "m", "seed": 1.5}),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_files_rejected_with_the_jax_message(case):
    validate, make = BROKEN[case]
    value = make()
    port, ref = _outcome(validate, port_schema, value), _outcome(validate, jax_schema, value)
    assert ref is not None, f"the JAX schema accepts the {case} case"
    assert port == ref


def test_schema_tables_are_the_jax_tables():
    for name in ("CONFIG_SCHEMA", "ENVIRONMENT_SCHEMA", "AUTOENCODER_TRAIN_SCHEMA",
                 "DIFFUSION_TRAIN_SCHEMA", "NOISE_SCHEDULER_SCHEMA"):
        port, ref = getattr(port_schema, name), getattr(jax_schema, name)
        assert list(port) == list(ref), name
        for key, spec in ref.items():
            if spec is jax_schema._TARGET:
                assert port[key] is port_schema._TARGET
            elif not isinstance(spec, dict):
                assert port[key] == spec, (name, key)
    assert issubclass(port_schema.ConfigSchemaError, ValueError)


def _merged(merge, env, cfg, **kw):
    args = argparse.Namespace()
    merge(args, env, cfg, **kw)
    return vars(args)


@pytest.mark.parametrize("env", [None, {"model_dir": "m"},
                                 {"model_dir": "m", "tfevent_path": "tb", "resume_ckpt": True}])
def test_merge_sets_the_jax_attributes(env, tmp_path):
    if env is None:
        env_path = port_preset_path("environment.json")
    else:
        env_path = tmp_path / "env.json"
        env_path.write_text(json.dumps(env))
    for name in ("config_train_stable.json", "config_micro_cpu.json"):
        cfg = port_preset_path(name)
        assert _merged(port_merge, str(env_path), cfg) == _merged(jax_merge, str(env_path), cfg)


def test_merge_validates_first_unless_told_not_to(tmp_path):
    env = tmp_path / "env.json"
    env.write_text(json.dumps({"model_dir": "m", "lpips_weight": "x.pt"}))
    cfg = port_preset_path("config_micro_cpu.json")
    with pytest.raises(port_schema.ConfigSchemaError, match="did you mean 'lpips_weights'") as e:
        _merged(port_merge, str(env), cfg)
    with pytest.raises(jax_schema.ConfigSchemaError) as ref:
        _merged(jax_merge, str(env), cfg)
    assert str(e.value) == str(ref.value)
    assert (_merged(port_merge, str(env), cfg, validate=False)
            == _merged(jax_merge, str(env), cfg, validate=False))


def test_resolve_config_and_register_match_jax():
    cfg = {"a": 2, "b": "$@a * 3", "nested": {"c": "@b"},
           "made": {"_target_": "tests.Recorder", "x": "@a", "y": "$[@b, 1]"}}
    for register in (port_register, jax_register):
        register("tests.Recorder", lambda **kw: dict(kw, built=True))
    try:
        port, ref = port_resolve_config(cfg), jax_resolve_config(cfg)
    finally:
        PORT_EXTRA.pop("tests.Recorder")
        JAX_EXTRA.pop("tests.Recorder")
    assert port == ref == {"a": 2, "b": 6, "nested": {"c": 6},
                           "made": {"x": 2, "y": [6, 1], "built": True}}


def _jax_param_count(model, shape, *extra) -> int:
    key = jax.random.PRNGKey(0)
    rngs = {"params": key, "sample": key} if not extra else key
    shapes = jax.eval_shape(lambda: model.init(rngs, jnp.zeros(shape), *extra))["params"]
    return sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("name", CONFIGS)
def test_every_preset_builds_with_the_jax_parameter_count(name):
    cfg = load_json(port_preset_path(name))
    r = ConfigResolver(cfg)
    jae, junet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    with torch.device("meta"):
        ns = SimpleNamespace(**cfg)
        tae = port_define_instance(ns, "autoencoder_def")
        tunet = port_define_instance(ns, "diffusion_def")
    want_ae = _jax_param_count(jae, (1, 8, 8, 8, cfg["image_channels"]))
    want_unet = _jax_param_count(junet, (1, 8, 8, 8, junet.in_channels),
                                 jnp.zeros((1,), jnp.int32))
    assert sum(p.numel() for p in tae.parameters()) == want_ae
    assert sum(p.numel() for p in tunet.parameters()) == want_unet
    assert tunet.mid_depth == junet.mid_depth
