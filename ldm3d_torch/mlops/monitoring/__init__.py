from ldm3d_torch.mlops.monitoring.model_monitoring import DriftDetector, ModelMonitoring

__all__ = ["DriftDetector", "ModelMonitoring"]
