from ldm3d_torch.obs.profiling import StepProfiler, Stopwatch
from ldm3d_torch.obs.tb import MetricsWriter
from ldm3d_torch.obs.visualize import normalize_image_to_uint8, visualize_one_slice_in_3d_image

__all__ = ["MetricsWriter", "StepProfiler", "Stopwatch", "normalize_image_to_uint8",
           "visualize_one_slice_in_3d_image"]
