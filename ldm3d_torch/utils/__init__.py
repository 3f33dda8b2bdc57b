from ldm3d_torch.utils.config_merge import TrainContext, merge_configs_onto_args

__all__ = ["merge_configs_onto_args", "TrainContext"]
