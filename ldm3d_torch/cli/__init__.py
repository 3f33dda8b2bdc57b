"""Entry points of the port (``python -m ldm3d_torch.cli.inference``)."""
