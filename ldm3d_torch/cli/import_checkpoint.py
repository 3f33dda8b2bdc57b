"""Import reference torch checkpoints into the port's model_dir.

The port of ``ldm3d_tpu/cli/import_checkpoint.py``. Migration path for users
of the reference: bring the ``.pt`` state_dicts its trainers wrote
(``autoencoder.pt`` / ``discriminator.pt`` / ``diffusion_unet.pt``,
reference ``train_autoencoder.py:629-647``, ``train_diffusion.py:291-305``)
and this tool writes them as the port's ``best`` checkpoints
(``autoencoder_best.pt``, ``discriminator_best.pt``, ``diffusion_best.pt``,
meta ``imported_from`` and, for the UNet, ``scale_factor``), after which
``cli.inference``, ``cli.evaluate``, the server and fine-tuning load them
unchanged. See :mod:`ldm3d_torch.ckpt.import_torch` for the structural
matching rules (registration-order pairing, q/k/v fusion).

The reference never persists the stage-2 latent ``scale_factor`` (its
inference silently uses 1.0); pass ``--scale-factor`` with the value logged
during reference training, or re-derive it here from data with
``--derive-scale-factor`` (one encode of the first training batch on the
device). ``--discriminator`` builds the config's ``discriminator_def``, as
the JAX CLI does; no bundled preset has one.

Usage:
  python -m ldm3d_torch.cli.import_checkpoint -c CFG -e ENV \\
      --autoencoder /path/autoencoder.pt [--discriminator d.pt] \\
      [--diffusion diffusion_unet.pt] [--scale-factor F | --derive-scale-factor] \\
      [--dump] [--device cuda|cpu]
"""

from __future__ import annotations

import logging

import torch

from ldm3d_torch.ckpt import CheckpointManager
from ldm3d_torch.ckpt.import_torch import (
    assigned_to_state_dict,
    autoencoder_manifest,
    flatten_torch_state_dict,
    match_state_dict,
    sequential_manifest,
    unet_manifest,
)
from ldm3d_torch.cli.common import build_parser, cli_main, reject_unported, setup
from ldm3d_torch.configs import define_instance

log = logging.getLogger("import_checkpoint")


def _import_one(name: str, path: str, template: dict, manifest_fn, dump: bool) -> dict:
    """The reference file at ``path`` as a state_dict shaped like ``template``."""
    manifest = manifest_fn(template)
    items = flatten_torch_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    if dump:
        print(f"== {name}: our manifest ({len(manifest)} leaves) ==")
        for e in manifest:
            print(f"  {e.path}  {e.kind}  {e.shape}")
        print(f"== {name}: torch state_dict ({len(items)} tensors) ==")
        for k, a in items:
            print(f"  {k}  {tuple(a.shape)}")
    sd = assigned_to_state_dict(template, match_state_dict(manifest, items))
    log.info("%s: matched %d torch tensors onto %d leaves", name, len(items), len(manifest))
    return sd


def _template(args, key: str) -> dict:
    """The state_dict layout of ``args.<key>``, built on the meta device."""
    with torch.device("meta"):
        return define_instance(args, key).state_dict()


def derive_scale_factor(args, ae_sd: dict, device: torch.device) -> float:
    """``1 / std`` of the posterior latents of the first training batch's
    labels (clipped to [0, 1]), encoded on ``device`` in fp32."""
    from ldm3d_torch.data import prepare_dataloader
    from ldm3d_torch.training import compute_scale_factor

    with torch.device("meta"):
        ae = define_instance(args, "autoencoder_def")
    ae.load_state_dict({k: v.to(device) for k, v in ae_sd.items()}, assign=True)
    ae.eval().requires_grad_(False)
    train_loader, _ = prepare_dataloader(
        args, 1, args.diffusion_train["patch_size"], randcrop=False,
        size_divisible=2 ** (len(args.autoencoder_def["channels"])
                             + len(args.diffusion_def["channels"]) - 2))
    batch = next(iter(train_loader.epoch(0)))
    labels = torch.clamp(torch.from_numpy(batch["label"]).to(device), 0, 1)
    f = ae.downsample_factor
    eps = torch.randn((labels.shape[0], *[s // f for s in labels.shape[1:4]], ae.latent_channels),
                      generator=torch.Generator(device=device).manual_seed(0), device=device)
    with torch.no_grad():
        return float(compute_scale_factor(ae, labels, eps))


@cli_main
def main(argv=None):
    parser = build_parser("Import reference torch checkpoints")
    parser.add_argument("--autoencoder", default=None, help="path to autoencoder.pt")
    parser.add_argument("--discriminator", default=None, help="path to discriminator.pt")
    parser.add_argument("--diffusion", default=None, help="path to diffusion_unet.pt")
    parser.add_argument("--scale-factor", type=float, default=None,
                        help="stage-2 latent scale factor from reference training logs")
    parser.add_argument("--derive-scale-factor", action="store_true",
                        help="recompute 1/std(encode(labels)) from the training data")
    parser.add_argument("--dump", action="store_true",
                        help="print both manifests (debugging mismatches)")
    args = parser.parse_args(argv)
    reject_unported(args, data_parallel=False)
    args, device = setup(args)

    if not (args.autoencoder or args.discriminator or args.diffusion):
        parser.error("nothing to import: pass --autoencoder / --discriminator / --diffusion")
    if args.diffusion and not (args.autoencoder or args.scale_factor is not None
                               or args.derive_scale_factor):
        log.warning("importing a diffusion UNet without --scale-factor: the reference "
                    "does not persist it; sampling will use 1.0 unless provided")

    ae_sd = None
    if args.autoencoder:
        ae_sd = _import_one("autoencoder", args.autoencoder, _template(args, "autoencoder_def"),
                            autoencoder_manifest, args.dump)
        CheckpointManager(args.model_dir, "autoencoder").save(
            "best", {"state_dict": ae_sd}, meta={"imported_from": args.autoencoder})
        log.info("saved autoencoder 'best' checkpoint to %s", args.model_dir)

    if args.discriminator:
        d_sd = _import_one("discriminator", args.discriminator,
                           _template(args, "discriminator_def"), sequential_manifest, args.dump)
        CheckpointManager(args.model_dir, "discriminator").save(
            "best", {"state_dict": d_sd}, meta={"imported_from": args.discriminator})
        log.info("saved discriminator 'best' checkpoint to %s", args.model_dir)

    if args.diffusion:
        log.warning("the UNet's up levels are matched in the JAX package's order, shallowest "
                    "first; MONAI's DiffusionModelUNet registers them deepest first, so a "
                    "real MONAI UNet checkpoint is unverified and likely refused at its first "
                    "up block (ROADMAP C10); the autoencoder's import is unaffected")
        u_sd = _import_one("diffusion", args.diffusion, _template(args, "diffusion_def"),
                           unet_manifest, args.dump)
        scale_factor = args.scale_factor
        if scale_factor is None and args.derive_scale_factor:
            if ae_sd is None:
                # deriving from a freshly built VAE would silently use random
                # weights: load the previously imported 'best' instead
                ae_ckpt = CheckpointManager(args.model_dir, "autoencoder")
                if not ae_ckpt.exists("best"):
                    parser.error(
                        "--derive-scale-factor needs trained VAE weights: pass "
                        "--autoencoder in the same run, or import it first so "
                        f"{ae_ckpt.path('best')} exists")
                ae_sd = ae_ckpt.load("best", map_location="cpu")["state_dict"]
                log.info("loaded existing autoencoder 'best' for scale-factor derivation")
            scale_factor = derive_scale_factor(args, ae_sd, device)
            log.info("derived scale_factor %.6f from data", scale_factor)
        CheckpointManager(args.model_dir, "diffusion").save(
            "best", {"state_dict": u_sd},
            meta={"imported_from": args.diffusion,
                  "scale_factor": float(scale_factor if scale_factor else 1.0)})
        log.info("saved diffusion 'best' checkpoint to %s (scale_factor=%s)",
                 args.model_dir, scale_factor or 1.0)


if __name__ == "__main__":
    main()
