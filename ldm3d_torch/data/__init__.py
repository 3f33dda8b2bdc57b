from ldm3d_torch.data.latent_cache import LatentCache
from ldm3d_torch.data.loader import BatchLoader, device_prefetch
from ldm3d_torch.data.npz_dataset import NPZPairDataset
from ldm3d_torch.data.pipeline import build_file_lists, prepare_dataloader, val_condition_volumes
from ldm3d_torch.data.synthetic import make_pair
from ldm3d_torch.data.transforms import center_crop_np, scale_intensity_percentiles_np

__all__ = ["BatchLoader", "LatentCache", "NPZPairDataset", "build_file_lists",
           "prepare_dataloader", "device_prefetch", "val_condition_volumes", "make_pair", "center_crop_np",
           "scale_intensity_percentiles_np"]
