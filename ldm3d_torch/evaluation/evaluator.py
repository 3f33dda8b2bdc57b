"""Model evaluator: scores generated volumes against ground truth, gates CI.

The port of ``ldm3d_tpu/evaluation/evaluator.py``:

* paired metrics: generated volumes against their ground-truth high-count
  partners, MAE, MSE, PSNR, SSIM and MS-SSIM (:mod:`.metrics`), per sample;
* a distributional metric: the Fréchet distance between frozen-VAE latent
  features of the generated and the real sets (:func:`latent_features`);
* the composite score in [0, 1] that the registration gate reads,
  ``0.5 SSIM + 0.25 min(PSNR / 40, 1) + 0.25 (1 - min(MAE, 1))``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from ldm3d_torch.cli.common import tf32_flags
from ldm3d_torch.evaluation import metrics as M

log = logging.getLogger("evaluation")

__all__ = ["EvalReport", "evaluate_pairs", "latent_features", "composite_score",
           "PSNR_CEILING_DB"]

PSNR_CEILING_DB = 40.0


@dataclasses.dataclass
class EvalReport:
    """Aggregated evaluation result; ``score`` is the gate's number."""

    num_samples: int
    mae: float
    mse: float
    psnr: float
    ssim: float
    ms_ssim: float
    frechet: Optional[float]
    score: float
    per_sample: dict  # metric name -> list of per-sample floats

    def passed(self, threshold: float) -> bool:
        return self.score > threshold

    def to_json(self) -> str:
        """The report as strict JSON: a value that is not finite is written
        as null, never as a NaN or Infinity token."""
        def _clean(v):
            if isinstance(v, float) and not math.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: _clean(x) for k, x in v.items()}
            if isinstance(v, list):
                return [_clean(x) for x in v]
            return v

        return json.dumps(_clean(dataclasses.asdict(self)), indent=2, allow_nan=False)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


def composite_score(ssim: float, psnr: float, mae: float) -> float:
    """The [0, 1] quality number of the registration gate (module docstring)."""
    psnr_term = min(max(psnr, 0.0) / PSNR_CEILING_DB, 1.0)
    mae_term = 1.0 - min(max(mae, 0.0), 1.0)
    return 0.5 * max(min(ssim, 1.0), 0.0) + 0.25 * psnr_term + 0.25 * mae_term


@torch.no_grad()
def latent_features(ae, volumes, pool: str = "meanstd") -> np.ndarray:
    """Per-volume features from the frozen VAE encoder's posterior mean (not a
    posterior sample, so the features carry no encoder noise): ``(B, D, H, W,
    C_img) -> z_mu (B, d, h, w, C_lat)``, pooled in fp32 over space to the
    mean, and with ``pool="meanstd"`` the population std beside it: ``(B,
    2 C_lat)``. The encoder runs on its own device with both ``allow_tf32``
    flags False."""
    device = next(ae.parameters()).device
    x = torch.as_tensor(volumes, dtype=torch.float32).to(device)
    with tf32_flags(False):
        z_mu, _ = ae.encode(x)
    z = z_mu.float().reshape(z_mu.shape[0], -1, z_mu.shape[-1])
    mean = torch.mean(z, dim=1)
    if pool == "mean":
        return mean.cpu().numpy()
    return torch.cat([mean, torch.std(z, dim=1, correction=0)], dim=-1).cpu().numpy()


def _paired_metrics(gen: torch.Tensor, ref: torch.Tensor) -> dict:
    """Every paired metric of one batch, ``(b,)`` each."""
    return {"mae": M.mae(gen, ref), "mse": M.mse(gen, ref), "psnr": M.psnr(gen, ref),
            "ssim": M.ssim3d(gen, ref), "ms_ssim": M.ms_ssim3d(gen, ref)}


def evaluate_pairs(generated: list, references: list, ae=None,
                   feature_fn: Optional[Callable] = None, device=None) -> EvalReport:
    """Score batches of generated volumes against ground-truth batches.

    ``generated``/``references``: equal-length lists of ``(b, D, H, W, C)``
    arrays or tensors. The paired metrics run on ``device`` (default: the
    VAE's device when ``ae`` is given, else the CPU). With ``ae`` (or a
    ``feature_fn``) the latent Fréchet distance of the whole sets is
    computed too, from 2 samples on. The report's PSNR takes an infinite
    per-sample value (identical volumes) as the 40 dB ceiling; a
    non-finite value of any other metric stays NaN, so the score is NaN and
    the gate fails closed."""
    if len(generated) != len(references) or not generated:
        raise ValueError("need equal, non-empty generated/reference batch lists")
    if device is None:
        device = next(ae.parameters()).device if ae is not None else torch.device("cpu")
    if feature_fn is None and ae is not None:
        feature_fn = lambda v: latent_features(ae, v)  # noqa: E731

    per: dict[str, list[float]] = {k: [] for k in ("mae", "mse", "psnr", "ssim", "ms_ssim")}
    feats_gen, feats_ref = [], []
    for gen_b, ref_b in zip(generated, references):
        gen_b = torch.as_tensor(gen_b, dtype=torch.float32).to(device)
        ref_b = torch.as_tensor(ref_b, dtype=torch.float32).to(device)
        with torch.no_grad():
            out = _paired_metrics(gen_b, ref_b)
        for k, v in out.items():
            per[k].extend(v.double().cpu().tolist())
        if feature_fn is not None:
            feats_gen.append(feature_fn(gen_b))
            feats_ref.append(feature_fn(ref_b))

    frechet = None
    if feats_gen:
        fg, fr = np.concatenate(feats_gen, 0), np.concatenate(feats_ref, 0)
        if fg.shape[0] >= 2:
            frechet = M.frechet_distance(fg, fr)
        else:
            log.warning("skipping Fréchet distance: need ≥2 samples, have %d", fg.shape[0])

    def _mean(k: str) -> float:
        vals = np.asarray(per[k], np.float64)
        if k == "psnr":
            vals = np.where(np.isfinite(vals), vals, PSNR_CEILING_DB)
        return float(vals.mean()) if vals.size else float("nan")

    mean_mae, mean_psnr, mean_ssim = _mean("mae"), _mean("psnr"), _mean("ssim")
    report = EvalReport(
        num_samples=len(per["mae"]), mae=mean_mae, mse=_mean("mse"), psnr=mean_psnr,
        ssim=mean_ssim, ms_ssim=_mean("ms_ssim"), frechet=frechet,
        score=composite_score(mean_ssim, mean_psnr, mean_mae),
        per_sample={k: [float(x) for x in v] for k, v in per.items()})
    log.info("eval: n=%d mae=%.4f psnr=%.2f ssim=%.4f ms-ssim=%.4f frechet=%s score=%.4f",
             report.num_samples, report.mae, report.psnr, report.ssim, report.ms_ssim,
             "n/a" if frechet is None else f"{frechet:.4f}", report.score)
    return report
