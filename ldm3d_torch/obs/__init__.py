from ldm3d_torch.obs.profiling import StepProfiler, Stopwatch
from ldm3d_torch.obs.tb import MetricsWriter
from ldm3d_torch.obs.visualize import visualize_one_slice_in_3d_image

__all__ = ["MetricsWriter", "StepProfiler", "Stopwatch", "visualize_one_slice_in_3d_image"]
