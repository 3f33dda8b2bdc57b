"""Convert the JAX package's checkpoints and LPIPS weights into the port's files.

The JAX trainers write orbax checkpoints under ``model_dir`` through
``ldm3d_tpu.ckpt.CheckpointManager`` (``autoencoder/{best,last}``,
``discriminator/best``, ``diffusion_unet/{best,last,ema,distilled}``, each
with a ``<role>_meta.json``); the PyTorch port reads ``torch.save`` files
(``ldm3d_torch.ckpt.CheckpointManager``: ``<name>_<role>.pt`` with its
``meta``). This script restores each role with the JAX manager, carries the
params through the port's weight bridge (``ldm3d_torch/ckpt/from_jax.py``)
and writes the port's layout:

* ``best``, ``ema`` and ``distilled``: the params under ``state_dict``, the
  JAX meta (``scale_factor``, the distilled grid) as the port's meta;
* ``last``: the params, Adam's moments and count carried into the port's
  ``ClippedAdam`` state (``exp_avg`` = optax's ``mu``, ``exp_avg_sq`` =
  ``nu``, ``step`` = ``count``, each moment through the same layout rule as
  its parameter), the update count and the EMA, so a run resumes with
  ``resume_ckpt`` where the JAX run stopped. Stage 1's ``last`` holds the
  generator and the discriminator; it carries no random-generator state (the
  port's trainer then starts its generator from the seed).

Runs made with ``--grad-accum`` (an ``optax.MultiSteps`` state) are refused.
``--lpips`` converts the flax msgpack that ``tools/convert_lpips.py`` writes
into a ``.pt`` state_dict of the port's LPIPS (the environment key
``lpips_weights``). Nothing is downloaded: the script reads files on disk.

This script imports both packages (JAX to restore, the port to write); the
port itself never imports JAX.

Usage:
  python tools/jax_to_torch_ckpt.py -c CONFIG --jax-model-dir DIR --out DIR
         [--stages autoencoder diffusion] [--roles best last ema distilled]
  python tools/jax_to_torch_ckpt.py --lpips lpips_squeeze.msgpack --lpips-out lpips.pt
"""

from __future__ import annotations

import argparse
import os
import sys
from types import SimpleNamespace
from typing import Iterable, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("autoencoder", "diffusion")
ROLES = ("best", "last", "ema", "distilled")


def _jax_models(cfg: dict):
    """The JAX autoencoder, discriminator (the trainer's) and UNet of
    ``cfg`` with their params' abstract shapes."""
    import jax
    import jax.numpy as jnp

    from ldm3d_tpu.configs import ConfigResolver
    from ldm3d_tpu.nn import PatchDiscriminator3D

    r = ConfigResolver(cfg)
    ae, unet = r.instantiate("autoencoder_def"), r.instantiate("diffusion_def")
    disc = PatchDiscriminator3D(num_layers_d=3, channels=32, in_channels=cfg["image_channels"],
                                out_channels=1)
    patch = cfg["autoencoder_train"]["patch_size"]
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, *patch, cfg["image_channels"]))
    latent = [p // ae.downsample_factor for p in cfg["diffusion_train"]["patch_size"]]
    shapes = {
        "autoencoder": jax.eval_shape(ae.init, {"params": key, "sample": key}, x)["params"],
        "discriminator": jax.eval_shape(disc.init, key, x)["params"],
        "diffusion": jax.eval_shape(unet.init, key, jnp.zeros((1, *latent, unet.in_channels)),
                                    jnp.zeros((1,), jnp.int32))["params"],
    }
    return shapes


def _abstract_train_state(params, tx) -> dict:
    """``{"params", "opt_state", "step"}`` of ``params``'s shapes under the
    optimizer ``tx`` (what the JAX trainers save as ``last``)."""
    import jax
    import jax.numpy as jnp

    def build(p):
        return {"params": p, "opt_state": tx.init(p), "step": jnp.zeros((), jnp.int32)}

    return jax.eval_shape(build, params)


def _adam_moments(opt_state):
    """``(count, mu, nu)`` of the one ``ScaleByAdamState`` in ``opt_state``."""
    import jax
    import optax

    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)

    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    if len(found) != 1:
        raise ValueError("the checkpoint's optimizer state holds no single Adam state "
                         "(a --grad-accum run's MultiSteps state is not converted)")
    s = found[0]
    return int(s.count), jax.device_get(s.mu), jax.device_get(s.nu)


def _port_model(cfg: dict, stage: str):
    from ldm3d_torch.configs import define_instance
    from ldm3d_torch.nn import PatchDiscriminator3D

    if stage == "discriminator":
        return PatchDiscriminator3D(num_layers_d=3, channels=32, in_channels=cfg["image_channels"],
                                    out_channels=1)
    return define_instance(SimpleNamespace(**cfg), "diffusion_def" if stage == "diffusion"
                           else "autoencoder_def")


def _port_optimizer_state(model, stage: str, count: int, mu, nu) -> dict:
    """The port's ``ClippedAdam.state_dict()`` holding the JAX moments."""
    import torch

    from ldm3d_torch.ckpt.from_jax import state_dict_from_jax
    from ldm3d_torch.training import make_diffusion_optimizer, make_optimizer

    opt = (make_diffusion_optimizer(model.parameters(), lambda _: 0.0) if stage == "diffusion"
           else make_optimizer(model.parameters(), lambda _: 0.0))
    if count > 0:
        m, v = state_dict_from_jax(mu, model), state_dict_from_jax(nu, model)
        for name, p in model.named_parameters():
            opt.adam.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m[name],
                                 "exp_avg_sq": v[name]}
    return opt.state_dict()


def _params_sd(params, model) -> dict:
    from ldm3d_torch.ckpt.from_jax import state_dict_from_jax

    return state_dict_from_jax(params, model)


def _port_train_state(state: dict, cfg: dict, stage: str) -> dict:
    """A restored JAX ``{"params", "opt_state", "step"[, "ema_params"]}`` as
    the port's ``TrainState.state_dict()``."""
    model = _port_model(cfg, stage)
    count, mu, nu = _adam_moments(state["opt_state"])
    out = {"params": _params_sd(state["params"], model),
           "optimizer": _port_optimizer_state(model, stage, count, mu, nu),
           "step": int(state["step"])}
    if "ema_params" in state:
        out["ema_params"] = _params_sd(state["ema_params"], model)
    return out


def convert(config_file: str, jax_model_dir: str, out_dir: str,
            stages: Iterable[str] = STAGES, roles: Iterable[str] = ROLES) -> list[str]:
    """Convert every role of ``roles`` that exists for each stage of
    ``stages`` (``autoencoder``: G's ``best``/``last`` and D's ``best``;
    ``diffusion``: ``best``, ``last``, ``ema``, ``distilled``). Returns the
    written files."""
    from ldm3d_torch.ckpt import CheckpointManager as PortManager
    from ldm3d_tpu.ckpt import CheckpointManager, StageArtifacts
    from ldm3d_tpu.configs import load_json
    from ldm3d_tpu.training import make_diffusion_optimizer
    from ldm3d_tpu.training.stage1 import make_optimizer

    cfg = load_json(config_file)
    shapes = _jax_models(cfg)
    roles = tuple(roles)
    written: list[str] = []

    def params_role(jax_name: str, port_name: str, stage: str, role: str) -> None:
        mgr = CheckpointManager(jax_model_dir, jax_name)
        if role not in roles or not mgr.exists(role):
            return
        model = _port_model(cfg, stage)
        sd = _params_sd(mgr.restore_params(role, shapes[stage]), model)
        out = PortManager(out_dir, port_name)
        out.save(role, {"state_dict": sd}, mgr.load_meta(role))
        written.append(out.path(role))

    for stage in stages:
        if stage == "autoencoder":
            params_role(StageArtifacts.AUTOENCODER, "autoencoder", "autoencoder", "best")
            params_role(StageArtifacts.DISCRIMINATOR, "discriminator", "discriminator", "best")
            g_mgr = CheckpointManager(jax_model_dir, StageArtifacts.AUTOENCODER)
            if "last" in roles and g_mgr.exists("last"):
                tx = make_optimizer(lambda _: 0.0)
                state = g_mgr.restore("last", {
                    "g": _abstract_train_state(shapes["autoencoder"], tx),
                    "d": _abstract_train_state(shapes["discriminator"], tx)})
                out = PortManager(out_dir, "autoencoder")
                out.save("last", {"g": _port_train_state(state["g"], cfg, "autoencoder"),
                                  "d": _port_train_state(state["d"], cfg, "discriminator")},
                         g_mgr.load_meta("last"))
                written.append(out.path("last"))
        elif stage == "diffusion":
            for role in ("best", "ema", "distilled"):
                params_role(StageArtifacts.DIFFUSION, "diffusion", "diffusion", role)
            u_mgr = CheckpointManager(jax_model_dir, StageArtifacts.DIFFUSION)
            if "last" in roles and u_mgr.exists("last"):
                abstract = _abstract_train_state(shapes["diffusion"],
                                                 make_diffusion_optimizer(lambda _: 0.0))
                try:  # a run with --ema-decay saved its EMA beside the state
                    state = u_mgr.restore("last", {**abstract,
                                                   "ema_params": abstract["params"]})
                except Exception:  # noqa: BLE001 - the run kept no EMA
                    state = u_mgr.restore("last", abstract)
                out = PortManager(out_dir, "diffusion")
                out.save("last", _port_train_state(state, cfg, "diffusion"),
                         u_mgr.load_meta("last"))
                written.append(out.path("last"))
        else:
            raise ValueError(f"unknown stage {stage!r}; choose from {STAGES}")
    return written


def convert_lpips(msgpack_path: str, out_path: str) -> str:
    """The flax LPIPS weights (``tools/convert_lpips.py``'s msgpack) as a
    ``.pt`` state_dict of the port's LPIPS."""
    import torch
    from flax import serialization

    from ldm3d_torch.ckpt.from_jax import lpips_state_dict_from_jax
    from ldm3d_torch.nn import LPIPS

    with open(msgpack_path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    params = tree.get("params", tree)
    torch.save(lpips_state_dict_from_jax(params, LPIPS()), out_path)
    return out_path


def main(argv: Optional[list] = None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config-file", help="the JAX run's config json (model definitions)")
    p.add_argument("--jax-model-dir", help="the JAX run's model_dir (orbax checkpoints)")
    p.add_argument("--out", help="the port's model_dir to write")
    p.add_argument("--stages", nargs="+", default=list(STAGES), choices=STAGES)
    p.add_argument("--roles", nargs="+", default=list(ROLES), choices=ROLES)
    p.add_argument("--lpips", help="a flax LPIPS msgpack to convert")
    p.add_argument("--lpips-out", help="where to write the LPIPS .pt (with --lpips)")
    args = p.parse_args(argv)
    if not args.lpips and not args.jax_model_dir:
        p.error("give --jax-model-dir (with -c and --out) or --lpips (with --lpips-out)")
    written = []
    if args.jax_model_dir:
        if not (args.config_file and args.out):
            p.error("--jax-model-dir needs -c CONFIG and --out DIR")
        written += convert(args.config_file, args.jax_model_dir, args.out, args.stages,
                           args.roles)
    if args.lpips:
        if not args.lpips_out:
            p.error("--lpips needs --lpips-out FILE.pt")
        written.append(convert_lpips(args.lpips, args.lpips_out))
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
