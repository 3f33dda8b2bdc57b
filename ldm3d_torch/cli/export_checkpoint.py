"""Export the port's checkpoints back to reference-style torch state_dicts.

The port of ``ldm3d_tpu/cli/export_checkpoint.py`` and the inverse of
:mod:`ldm3d_torch.cli.import_checkpoint`: writes the ``best`` checkpoints
(the UNet's ``ema`` with ``--use-ema``) as ``torch.save``-format ``.pt``
files of fp32 tensors laid out in the reference's module-REGISTRATION ORDER
(OIDHW convs, (out, in) linears; split ``to_q/to_k/to_v`` attention by
default, ``--fused-qkv`` for the SABlock layout).

Key naming: tensors keep the port's ``state_dict`` names — torch's
``load_state_dict`` matches by name, and MONAI's names vary across versions,
so none is guessed. Loading into a MONAI model is a one-liner because the
ORDER matches its registration order (the contract the importer reads by):

    ref_sd  = model.state_dict()            # target MONAI model
    ours    = torch.load("out_ae.pt")
    model.load_state_dict({k: v for k, v in zip(ref_sd, ours.values())})

(Use ``--fused-qkv`` iff the target MONAI version fuses qkv, so tensor counts
line up.) Round-trip through the importer is exact. The reference never
saves the latent ``scale_factor``: it is logged, to be recorded for
torch-side sampling. A ``mid_depth > 0`` UNet's ``mid_stack`` has no
reference counterpart and is not written, as in the JAX CLI.

Usage:
  python -m ldm3d_torch.cli.export_checkpoint -c CFG -e ENV \\
      [--autoencoder out_ae.pt] [--diffusion out_unet.pt] [--fused-qkv] [--use-ema] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import logging

import torch

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.ckpt.import_torch import (
    autoencoder_manifest,
    export_torch_state_dict,
    unet_manifest,
)
from ldm3d_torch.cli.common import build_parser, cli_main, reject_unported, setup
from ldm3d_torch.configs import define_instance

log = logging.getLogger("export_checkpoint")


def _checked_state_dict(args, key: str, state_dict: dict) -> dict:
    """``state_dict`` loaded strictly into ``args.<key>``'s architecture
    (built on the meta device), so a checkpoint of another config raises."""
    with torch.device("meta"):
        model = define_instance(args, key)
    model.load_state_dict(state_dict, assign=True)
    return model.state_dict()


@cli_main
def main(argv=None):
    parser = build_parser("Export checkpoints to reference torch format")
    parser.add_argument("--autoencoder", default=None, help="output path for autoencoder.pt")
    parser.add_argument("--diffusion", default=None, help="output path for diffusion_unet.pt")
    parser.add_argument("--fused-qkv", action="store_true",
                        help="emit fused SABlock-style qkv tensors (default: split to_q/to_k/to_v)")
    parser.add_argument("--use-ema", action="store_true", help="export the EMA UNet weights")
    args = parser.parse_args(argv)
    if not (args.autoencoder or args.diffusion):
        parser.error("nothing to export: pass --autoencoder and/or --diffusion")
    reject_unported(args, data_parallel=False)
    args, _ = setup(args)
    qkv_mode = "fused" if args.fused_qkv else "split"

    if args.autoencoder:
        sd = CheckpointManager(args.model_dir, "autoencoder").load(
            "best", map_location="cpu")["state_dict"]
        sd = _checked_state_dict(args, "autoencoder_def", sd)
        out = export_torch_state_dict(autoencoder_manifest(sd), sd, qkv_mode)
        torch.save(out, args.autoencoder)
        log.info("wrote %s (%d tensors)", args.autoencoder, len(out))

    if args.diffusion:
        u_ckpt = CheckpointManager(args.model_dir, "diffusion")
        role = "ema" if args.use_ema else "best"
        if args.use_ema and not u_ckpt.exists("ema"):
            raise FileNotFoundError("no 'ema' checkpoint found; train with --ema-decay first")
        sd = _checked_state_dict(args, "diffusion_def",
                                 u_ckpt.load(role, map_location="cpu")["state_dict"])
        scale_factor = float(u_ckpt.load_meta("best").get("scale_factor", 1.0))
        out = export_torch_state_dict(unet_manifest(sd), sd, qkv_mode)
        skipped = sum(k.startswith("mid_stack.") for k in sd)
        if skipped:
            log.warning("the mid_depth stack's %d tensors have no reference counterpart and "
                        "are not exported", skipped)
        torch.save(out, args.diffusion)
        log.info("wrote %s (%d tensors; note: the reference never persists "
                 "scale_factor=%.6f — record it for torch-side sampling)",
                 args.diffusion, len(out), scale_factor)


if __name__ == "__main__":
    main()
