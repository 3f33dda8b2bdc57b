from ldm3d_torch.mlops.deployment.deploy_model import DeployError, ModelDeployment

__all__ = ["DeployError", "ModelDeployment"]
