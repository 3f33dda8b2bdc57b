"""Experiment tracking: the local JSON fallback of ``ldm3d_tpu/mlops``."""

from ldm3d_torch.mlops.tracking import ExperimentTracker, ModelRegistry, log_training_run

__all__ = ["ExperimentTracker", "ModelRegistry", "log_training_run"]
