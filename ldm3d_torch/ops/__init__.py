from ldm3d_torch.ops.attention import (
    FlashAttention,
    attention_bwd_reference,
    attention_reference,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    volumetric_attention,
)
from ldm3d_torch.ops.groupnorm import gn_bwd_sums, gn_bwd_sums_reference, gn_sums, gn_sums_reference

__all__ = ["FlashAttention", "attention_reference", "attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "volumetric_attention", "gn_sums", "gn_bwd_sums", "gn_sums_reference",
           "gn_bwd_sums_reference"]
