"""Import reference (torch/MONAI) checkpoints into the port's models.

The port's own copy of ``ldm3d_tpu/ckpt/import_torch.py``, written over the
port's ``state_dict`` instead of Flax trees. The reference saves raw
``state_dict`` files with ``torch.save`` (``3d_ldm/train_autoencoder.py:629-647``,
``train_diffusion.py:291-305``): ``autoencoder.pt``, ``discriminator.pt``,
``diffusion_unet.pt``. This module maps them onto the port's parameters so
inference, evaluation, serving and fine-tuning continue without retraining.

Matching is **structural**, not name-based: MONAI renamed its attention
blocks between 1.3 and 1.4 (``AttentionBlock`` with separate
``to_q/to_k/to_v`` vs ``SpatialAttentionBlock`` wrapping a fused-``qkv``
SABlock), so trusting key names is brittle. Instead:

  1. ``state_dict`` preserves module **registration order**, which for these
     architectures is a deterministic structural order;
  2. both architectures are built from the same JSON config, so the i-th
     parameter tensor on each side plays the same role.

The manifests (:func:`autoencoder_manifest`, :func:`unet_manifest`,
:func:`sequential_manifest`) emit the port's parameters in MONAI's
registration order, the order the JAX package's manifests encode (not the
port's own ``state_dict`` order); :func:`match_state_dict` walks the torch
tensors in ``state_dict`` order and pairs them under strict shape checks.
Both sides are OIDHW convolutions and ``(out, in)`` linears, so no tensor is
transposed. The one rewrite is attention's q/k/v: three separate ``(C, C)``
``to_q/to_k/to_v`` linears (and their biases) become the port's fused
``qkv`` ``(3C, C)``, q rows first (``AttentionBlock3D`` chunks its output in
q, k, v order); an already-fused ``(3C, C)`` tensor passes through.

Any shape mismatch aborts with a side-by-side dump of both sides around the
failure point; leftover torch tensors are rejected and a parameter no
tensor filled is an error. Nothing is coerced silently.

The UNet's ``mid_depth`` stack (``mid_stack.{i}``) has no reference
counterpart: the manifest leaves it out, as the JAX package's does, so an
import into a ``mid_depth > 0`` UNet stops at its first unfilled parameter,
and an export of one carries no ``mid_stack`` tensor.
"""

from __future__ import annotations

import dataclasses
import re
from collections import OrderedDict
from typing import Any, Mapping, Optional

import torch

__all__ = [
    "ManifestEntry",
    "autoencoder_manifest",
    "unet_manifest",
    "sequential_manifest",
    "flatten_torch_state_dict",
    "match_state_dict",
    "assigned_to_state_dict",
    "export_torch_state_dict",
    "ImportMismatchError",
]

# torch buffers that carry no learnable state
_SKIP_KEY_RE = re.compile(r"(num_batches_tracked|running_mean|running_var)$")


class ImportMismatchError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    """One of the port's parameters, in reference registration order.

    ``path`` is its ``state_dict`` key. ``kind`` drives the pairing rule:
    ``conv`` (5-D weight), ``dense`` (2-D weight), ``qkv`` (fused attention
    in-projection) and ``qkv_bias``, ``scale``/``bias`` (1-D vectors)."""

    path: str
    kind: str
    shape: tuple


def _tree(state_dict: Mapping[str, Any]) -> dict:
    """The ``state_dict`` as nested dicts of module names (the Flax tree's
    names), so the manifests can walk it as the JAX package walks params."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    root: dict = {}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return root


def _leaf(params, path):
    node = params
    for k in path:
        node = node[k]
    return node


def _module_entries(params, path: tuple) -> list[ManifestEntry]:
    """Entries for one leaf module, in torch's weight-then-bias order."""
    mod = _leaf(params, path)
    name = ".".join(path)
    out = []
    if "weight" in mod:
        w = mod["weight"]
        if path[-1] == "qkv":
            kind = "qkv"
        elif w.dim() >= 3:
            kind = "conv"
        elif w.dim() == 2:
            kind = "dense"
        else:
            kind = "scale"
        out.append(ManifestEntry(f"{name}.weight", kind, tuple(w.shape)))
    if "bias" in mod:
        kind = "qkv_bias" if path[-1] == "qkv" else "bias"
        out.append(ManifestEntry(f"{name}.bias", kind, tuple(mod["bias"].shape)))
    return out


def _norm_conv(params, prefix: tuple, norm: str, conv: str) -> list[ManifestEntry]:
    return _module_entries(params, prefix + (norm,)) + _module_entries(params, prefix + (conv,))


def _resblock_entries(params, prefix: tuple, with_time: bool) -> list[ManifestEntry]:
    """MONAI ResBlock registration order: norm1, conv1, (time_emb_proj,)
    norm2, conv2, shortcut-if-present (reference AEKLResBlock /
    DiffusionUNetResnetBlock layouts)."""
    node = _leaf(params, prefix)
    out = _norm_conv(params, prefix, "norm1", "conv1")
    if with_time and "time_proj" in node:
        out += _module_entries(params, prefix + ("time_proj",))
    out += _norm_conv(params, prefix, "norm2", "conv2")
    if "shortcut" in node:
        out += _module_entries(params, prefix + ("shortcut",))
    return out


def _attn_entries(params, prefix: tuple) -> list[ManifestEntry]:
    """Attention block: norm, qkv (fused here; split or fused in torch), proj."""
    return (
        _module_entries(params, prefix + ("norm",))
        + _module_entries(params, prefix + ("qkv",))
        + _module_entries(params, prefix + ("proj",))
    )


def _sorted_children(params, pattern: str) -> list[str]:
    rx = re.compile(pattern)
    names = [k for k in params if rx.fullmatch(k)]
    return sorted(names, key=lambda s: [int(t) if t.isdigit() else t
                                        for t in re.split(r"(\d+)", s)])


def _level_indices(params, side: str) -> list[int]:
    return sorted({int(m.group(1)) for k in params if (m := re.match(rf"{side}_(\d+)_", k))})


def autoencoder_manifest(state_dict) -> list[ManifestEntry]:
    """The port's AutoencoderKL parameters in MONAI AutoencoderKL
    registration order.

    MONAI builds flat ``blocks`` ModuleLists in execution order — encoder:
    conv_in, then per level interleaved (res, attn?)*num_res_blocks then
    downsample, then norm_out + conv_out; decoder mirrors it with upsamples;
    then quant_conv_mu, quant_conv_log_sigma, post_quant_conv (module
    ``__init__`` order: encoder, decoder, quant_mu, quant_log_sigma,
    post_quant). The non-local attention mid stack sits after the down
    levels in the encoder and right after conv_in in the decoder."""
    params = _tree(state_dict)
    out: list[ManifestEntry] = []

    def _side(side_key: str, level_prefix: str, resample: str):
        side = params[side_key]
        out.extend(_module_entries(params, (side_key, "conv_in")))

        def _mid():
            if "mid_res_1" in side:
                out.extend(_resblock_entries(params, (side_key, "mid_res_1"), with_time=False))
                out.extend(_attn_entries(params, (side_key, "mid_attn")))
                out.extend(_resblock_entries(params, (side_key, "mid_res_2"), with_time=False))

        if level_prefix == "up":
            _mid()
        for lvl in _level_indices(side, level_prefix):
            res_names = _sorted_children(side, rf"{level_prefix}_{lvl}_res_\d+")
            attn_names = _sorted_children(side, rf"{level_prefix}_{lvl}_attn_\d+")
            # MONAI appends attn right after each res block at attention levels
            for i, rn in enumerate(res_names):
                out.extend(_resblock_entries(params, (side_key, rn), with_time=False))
                if i < len(attn_names):
                    out.extend(_attn_entries(params, (side_key, attn_names[i])))
            rs = f"{level_prefix}_{lvl}_{resample}"
            if rs in side:
                out.extend(_module_entries(params, (side_key, rs, "conv")))
        if level_prefix == "down":
            _mid()
        out.extend(_module_entries(params, (side_key, "norm_out")))
        out.extend(_module_entries(params, (side_key, "conv_out")))

    _side("encoder", "down", "downsample")
    _side("decoder", "up", "upsample")
    for q in ("quant_conv_mu", "quant_conv_log_sigma", "post_quant_conv"):
        out.extend(_module_entries(params, (q,)))
    return out


def unet_manifest(state_dict) -> list[ManifestEntry]:
    """The port's DiffusionUNet3D parameters in the order of the JAX
    package's ``unet_manifest``: conv_in, time_embed (two linears), down
    blocks (each: ALL resnets, then ALL attentions, then downsampler —
    ModuleList registration, not execution interleaving), middle (res_1,
    attn, res_2), up blocks by ascending level name (same grouping,
    upsampler last), final norm + conv_out. ``mid_stack`` is not in it."""
    params = _tree(state_dict)
    out: list[ManifestEntry] = []
    out.extend(_module_entries(params, ("conv_in",)))
    out.extend(_module_entries(params, ("time_embed", "fc1")))
    out.extend(_module_entries(params, ("time_embed", "fc2")))

    def _blocks(prefix: str, resample: Optional[str]):
        for lvl in _level_indices(params, prefix):
            for rn in _sorted_children(params, rf"{prefix}_{lvl}_res_\d+"):
                out.extend(_resblock_entries(params, (rn,), with_time=True))
            for an in _sorted_children(params, rf"{prefix}_{lvl}_attn_\d+"):
                out.extend(_attn_entries(params, (an,)))
            if resample and f"{prefix}_{lvl}_{resample}" in params:
                out.extend(_module_entries(params, (f"{prefix}_{lvl}_{resample}", "conv")))

    _blocks("down", "downsample")
    out.extend(_resblock_entries(params, ("mid_res_1",), with_time=True))
    if "mid_attn" in params:
        out.extend(_attn_entries(params, ("mid_attn",)))
    out.extend(_resblock_entries(params, ("mid_res_2",), with_time=True))
    _blocks("up", "upsample")
    out.extend(_module_entries(params, ("norm_out",)))
    out.extend(_module_entries(params, ("conv_out",)))
    return out


def sequential_manifest(state_dict) -> list[ManifestEntry]:
    """Plain ordered-conv models (PatchDiscriminator: conv_0..conv_N,
    conv_out; InstanceNorm carries no parameters)."""
    params = _tree(state_dict)
    out: list[ManifestEntry] = []
    for name in _sorted_children(params, r"conv_\d+") + ["conv_out"]:
        out.extend(_module_entries(params, (name,)))
    return out


# -- torch side ------------------------------------------------------------


def flatten_torch_state_dict(sd) -> list[tuple[str, torch.Tensor]]:
    """Ordered (key, tensor) list on the CPU; strips DDP ``module.``
    prefixes and non-learnable buffers. Accepts dict-like or
    {'state_dict': ...} wrappers, and numpy values."""
    if hasattr(sd, "keys") and "state_dict" in sd and hasattr(sd["state_dict"], "keys"):
        sd = sd["state_dict"]
    out = []
    for k, v in sd.items():
        if _SKIP_KEY_RE.search(k):
            continue
        key = k[len("module."):] if k.startswith("module.") else k
        out.append((key, v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)))
    return out


def _context(entries, i, width=3):
    lo, hi = max(0, i - width), min(len(entries), i + width + 1)
    return "\n".join(f"  [{j}]{' ->' if j == i else '   '} {e}"
                     for j, e in enumerate(entries[lo:hi], lo))


def match_state_dict(manifest: list[ManifestEntry],
                     torch_items: list[tuple[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Pair torch tensors with manifest entries; returns ``{state_dict key:
    tensor}``.

    Walks both sequences in lockstep. ``qkv`` entries may consume one fused
    torch tensor or three split q/k/v tensors (their biases likewise).
    Raises :class:`ImportMismatchError` with a side-by-side context dump on
    any shape disagreement, and on torch tensors left over at the end."""
    assigned: dict[str, torch.Tensor] = {}
    ti = 0

    def _take(expect_desc):
        nonlocal ti
        if ti >= len(torch_items):
            raise ImportMismatchError(
                f"torch checkpoint exhausted while looking for {expect_desc};\n"
                f"manifest context:\n{_context([e.path for e in manifest], len(manifest) - 1)}")
        item = torch_items[ti]
        ti += 1
        return item

    for mi, entry in enumerate(manifest):
        try:
            if entry.kind in ("conv", "dense"):
                key, w = _take(entry)
                if tuple(w.shape) != entry.shape:
                    raise ImportMismatchError(
                        f"{entry.kind} shape mismatch at {entry.path}: ours {entry.shape}, "
                        f"got {key} {tuple(w.shape)}")
                assigned[entry.path] = w
            elif entry.kind == "qkv":
                c3, c = entry.shape
                key, w = _take(entry)
                if tuple(w.shape) == (c3, c):  # fused qkv (SABlock-style)
                    assigned[entry.path] = w
                elif tuple(w.shape) == (c, c):  # split to_q/to_k/to_v: consume 2 more
                    parts = [w]
                    biases = []
                    # torch order: to_q.weight, to_q.bias?, to_k.weight, ...
                    if ti < len(torch_items) and tuple(torch_items[ti][1].shape) == (c,):
                        biases.append(_take("to_q.bias")[1])
                    for name in ("to_k", "to_v"):
                        k2, w2 = _take(f"{name}.weight")
                        if tuple(w2.shape) != (c, c):
                            raise ImportMismatchError(
                                f"split-qkv {name} at {entry.path}: expected ({c},{c}), "
                                f"got {k2} {tuple(w2.shape)}")
                        parts.append(w2)
                        if (ti < len(torch_items) and tuple(torch_items[ti][1].shape) == (c,)
                                and biases):
                            biases.append(_take(f"{name}.bias")[1])
                    assigned[entry.path] = torch.cat(parts, dim=0)
                    if biases:
                        if len(biases) != 3:
                            raise ImportMismatchError(
                                f"split-qkv at {entry.path}: {len(biases)} biases (need 0 or 3)")
                        assigned[entry.path.removesuffix("weight") + "bias"] = torch.cat(biases)
                else:
                    raise ImportMismatchError(
                        f"qkv at {entry.path}: expected fused ({c3},{c}) or split ({c},{c}), "
                        f"got {key} {tuple(w.shape)}")
            elif entry.kind == "qkv_bias":
                if entry.path in assigned:  # already filled by the split path
                    continue
                key, b = _take(entry)
                if tuple(b.shape) == entry.shape:  # fused bias
                    assigned[entry.path] = b
                else:
                    raise ImportMismatchError(
                        f"qkv bias at {entry.path}: expected {entry.shape}, got {key} "
                        f"{tuple(b.shape)}")
            else:  # scale / bias (1-D, or 0-D oddities): shapes must agree exactly
                key, v = _take(entry)
                if tuple(v.shape) != entry.shape:
                    raise ImportMismatchError(
                        f"{entry.kind} shape mismatch at {entry.path}: ours {entry.shape}, "
                        f"got {key} {tuple(v.shape)}")
                assigned[entry.path] = v
        except ImportMismatchError as e:
            torch_keys = [f"{k} {tuple(a.shape)}" for k, a in torch_items]
            ours = [f"{e2.path} {e2.kind} {e2.shape}" for e2 in manifest]
            raise ImportMismatchError(
                f"{e}\n\n-- our manifest around entry {mi}:\n{_context(ours, mi)}\n"
                f"-- torch state_dict around tensor {min(ti, len(torch_keys) - 1)}:\n"
                f"{_context(torch_keys, min(ti, len(torch_keys) - 1))}\n"
                f"(use --dump to print both manifests in full)") from None

    if ti != len(torch_items):
        leftovers = ", ".join(k for k, _ in torch_items[ti:ti + 8])
        raise ImportMismatchError(
            f"{len(torch_items) - ti} torch tensors left unconsumed (first: {leftovers}); "
            f"the architectures differ")
    return assigned


def assigned_to_state_dict(template: Mapping[str, torch.Tensor],
                           assigned: Mapping[str, torch.Tensor]) -> OrderedDict:
    """A ``state_dict`` with ``template``'s keys, order and dtypes filled
    from ``assigned``; raises at the first parameter no tensor filled."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, like in template.items():
        value = assigned.get(key)
        if value is None:
            raise ImportMismatchError(f"no torch tensor assigned for {key}")
        out[key] = value.to(like.dtype).contiguous()
    return out


def export_torch_state_dict(manifest: list[ManifestEntry], state_dict,
                            qkv_mode: str = "split") -> "OrderedDict[str, torch.Tensor]":
    """Inverse of :func:`match_state_dict`: an ordered torch ``state_dict``
    of fp32 tensors in the reference's registration ORDER. Keys are the
    port's ``state_dict`` names (MONAI's names vary by version, so none is
    guessed); loading into a MONAI model is a zip over its ``state_dict()``
    keys (see ``cli/export_checkpoint.py``).

    ``qkv_mode``: ``"split"`` emits MONAI-1.3-style ``to_q/to_k/to_v``
    Linear weights and biases, interleaved; ``"fused"`` emits one
    SABlock-style ``qkv`` tensor and its bias. Round-trip with the importer
    is exact."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def leaf(key):
        return state_dict[key].detach().to("cpu", torch.float32).clone().contiguous()

    for e in manifest:
        a = leaf(e.path)
        if e.kind == "qkv":
            c = a.shape[1]
            if qkv_mode == "fused":
                out[e.path] = a
            else:
                module = e.path.removesuffix(".qkv.weight")
                b = leaf(e.path.removesuffix("weight") + "bias")
                for i, nm in enumerate(("to_q", "to_k", "to_v")):
                    out[f"{module}.{nm}.weight"] = a[i * c:(i + 1) * c].clone()
                    out[f"{module}.{nm}.bias"] = b[i * c:(i + 1) * c].clone()
        elif e.kind == "qkv_bias":
            if qkv_mode == "fused":
                out[e.path] = a
            # split mode: biases already emitted interleaved above
        else:
            out[e.path] = a
    return out

