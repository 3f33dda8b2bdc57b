from ldm3d_torch.data.pipeline import build_file_lists, val_condition_volumes
from ldm3d_torch.data.synthetic import make_pair
from ldm3d_torch.data.transforms import center_crop_np, scale_intensity_percentiles_np

__all__ = ["build_file_lists", "val_condition_volumes", "make_pair", "center_crop_np",
           "scale_intensity_percentiles_np"]
