"""The Hopper kernels' public entries. Each `*_or_none` returns None where
its kernels do not take the call (CPU tensors for attention; the switch off
or a shape outside the gate), and the caller takes its plain path."""

from medvae_tpu_torch.ops.attention import fused_attention_or_none
from medvae_tpu_torch.ops.groupnorm_swish import fused_group_norm_swish_or_none

__all__ = ["fused_attention_or_none", "fused_group_norm_swish_or_none"]
