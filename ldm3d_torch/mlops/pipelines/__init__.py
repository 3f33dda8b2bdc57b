from ldm3d_torch.mlops.pipelines.training_pipeline import (
    BatchInferencePipeline,
    TrainingPipeline,
)

__all__ = ["TrainingPipeline", "BatchInferencePipeline"]
