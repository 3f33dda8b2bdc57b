from ldm3d_torch.ops.attention import attention_reference, flash_attention_fwd, volumetric_attention

__all__ = ["attention_reference", "flash_attention_fwd", "volumetric_attention"]
