from ldm3d_torch.serving.metrics import REGISTRY, Counter, Gauge, Histogram
from ldm3d_torch.serving.model_server import ModelServer

__all__ = ["ModelServer", "REGISTRY", "Counter", "Gauge", "Histogram"]
