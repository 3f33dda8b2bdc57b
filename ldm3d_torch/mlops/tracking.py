"""Experiment tracking and a model registry, in local JSON files.

The port of ``ldm3d_tpu/mlops/tracking.py`` without its MLflow backend: a
run is recorded in the JAX package's fallback tree,
``<tracking_root>/<experiment>/<run_id>/`` with ``meta.json``,
``params.json``, ``metrics.jsonl`` and ``artifacts/``, through the same
calls. The port neither imports nor needs ``mlflow``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
import uuid
from typing import Optional

__all__ = ["ExperimentTracker", "ModelRegistry", "log_training_run"]


class ExperimentTracker:
    """Runs recorded as JSON files under ``tracking_root``."""

    def __init__(self, experiment_name: str = "ldm3d-tpu", tracking_root: str = "./mlruns_local"):
        self.experiment_name = experiment_name
        self.tracking_root = tracking_root
        self._run_dir: Optional[str] = None
        self._active = False
        self._metrics: list[dict] = []
        self._params: dict = {}

    # -- run lifecycle ---------------------------------------------------------

    def start_run(self, run_name: Optional[str] = None, tags: Optional[dict] = None) -> str:
        run_id = uuid.uuid4().hex[:12]
        self._run_dir = os.path.join(self.tracking_root, self.experiment_name, run_id)
        os.makedirs(os.path.join(self._run_dir, "artifacts"), exist_ok=True)
        self._write("meta.json", {"run_id": run_id, "run_name": run_name,
                                  "tags": tags or {}, "start_time": time.time()})
        self._metrics, self._params = [], {}
        self._active = True
        return run_id

    def end_run(self, status: str = "FINISHED") -> None:
        if not self._active:
            return
        self._write("params.json", self._params)
        self._write("metrics.jsonl", None, lines=self._metrics)
        meta = self._read("meta.json")
        meta.update({"end_time": time.time(), "status": status})
        self._write("meta.json", meta)
        self._active = False

    # -- logging ---------------------------------------------------------------

    def log_params(self, params: dict) -> None:
        self._params.update({k: repr(v) for k, v in params.items()})

    def log_metrics(self, metrics: dict, step: Optional[int] = None) -> None:
        self._metrics.append({"step": step, "time": time.time(),
                              **{k: float(v) for k, v in metrics.items()}})

    def log_artifact(self, path: str, artifact_path: Optional[str] = None) -> None:
        """``artifact_path``: an optional subdirectory, for artifacts that
        share a basename (each stage's ``best_meta.json``)."""
        if self._run_dir:
            dest = os.path.join(self._run_dir, "artifacts", artifact_path or "")
            os.makedirs(dest, exist_ok=True)
            shutil.copy(path, os.path.join(dest, os.path.basename(path)))

    # -- helpers -----------------------------------------------------------------

    def _write(self, name: str, obj, lines: Optional[list] = None) -> None:
        with open(os.path.join(self._run_dir, name), "w") as f:
            if lines is not None:
                for rec in lines:
                    f.write(json.dumps(rec) + "\n")
            else:
                json.dump(obj, f, indent=2)

    def _read(self, name: str) -> dict:
        with open(os.path.join(self._run_dir, name)) as f:
            return json.load(f)


class ModelRegistry:
    """Register, promote and resolve model versions in a local JSON index
    (stages None -> Staging -> Production, and Archived). Writes hold an
    advisory file lock and commit atomically (tmp + rename)."""

    STAGES = ("None", "Staging", "Production", "Archived")

    def __init__(self, registry_root: str = "./model_registry"):
        self.registry_root = registry_root
        os.makedirs(registry_root, exist_ok=True)
        self._index_path = os.path.join(registry_root, "index.json")
        self._lock_path = os.path.join(registry_root, ".index.lock")

    @contextlib.contextmanager
    def _locked(self):
        import fcntl

        with open(self._lock_path, "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_f, fcntl.LOCK_UN)

    def _index(self) -> dict:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {}

    def _save_index(self, idx: dict) -> None:
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(idx, f, indent=2)
        os.replace(tmp, self._index_path)

    def register(self, name: str, checkpoint_dir: str, metrics: Optional[dict] = None) -> int:
        with self._locked():
            idx = self._index()
            versions = idx.setdefault(name, [])
            version = len(versions) + 1
            versions.append({"version": version,
                             "checkpoint_dir": os.path.abspath(checkpoint_dir),
                             "metrics": metrics or {}, "stage": "None",
                             "registered_at": time.time()})
            self._save_index(idx)
        return version

    def promote(self, name: str, version: int, stage: str) -> None:
        if stage not in self.STAGES:
            raise ValueError(f"stage must be one of {self.STAGES}")
        with self._locked():
            idx = self._index()
            for entry in idx.get(name, []):
                if entry["version"] == version:
                    entry["stage"] = stage
                    self._save_index(idx)
                    return
        raise KeyError(f"{name} v{version} not found")

    def get(self, name: str, stage: str = "Production") -> Optional[dict]:
        candidates = [e for e in self._index().get(name, []) if e["stage"] == stage]
        return max(candidates, key=lambda e: e["version"]) if candidates else None


# the port's checkpoint sidecars (ldm3d_torch.ckpt.CheckpointManager writes
# <model_dir>/<name>_best_meta.json) and the artifact subdirectory each is
# logged under: the JAX package's stage directory names
_BEST_METAS = (("autoencoder", "autoencoder"), ("discriminator", "discriminator"),
               ("diffusion", "diffusion_unet"))


def log_training_run(tracker: ExperimentTracker, config: dict, final_metrics: dict,
                     checkpoint_dir: Optional[str] = None, run_name: Optional[str] = None) -> str:
    """Start a run, log ``config`` and ``final_metrics`` and each stage's
    ``best`` meta found in ``checkpoint_dir``, end it; returns the run id.
    The metas land where the JAX package puts them,
    ``artifacts/<stage>/best_meta.json``."""
    run_id = tracker.start_run(run_name=run_name)
    try:
        tracker.log_params(config)
        tracker.log_metrics(final_metrics)
        if checkpoint_dir and os.path.isdir(checkpoint_dir):
            with tempfile.TemporaryDirectory() as staging:
                staged = os.path.join(staging, "best_meta.json")
                for name, sub in _BEST_METAS:
                    meta = os.path.join(checkpoint_dir, f"{name}_best_meta.json")
                    if os.path.exists(meta):
                        shutil.copy(meta, staged)
                        tracker.log_artifact(staged, artifact_path=sub)
        tracker.end_run("FINISHED")
    except Exception:
        tracker.end_run("FAILED")
        raise
    return run_id
