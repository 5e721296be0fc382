"""Mixed-precision policy of the port (counterpart of medvae_tpu/core/precision.py).

Params in float32; compute (activations, conv operands) in bfloat16, or in
float32 for `precision: fp32`. Norm statistics and the routing products run in
float32 in both.
"""

from __future__ import annotations

import torch


def compute_dtype_for(precision: str) -> torch.dtype:
    """The compute dtype a config's `precision` names: bf16 (the default) or fp32."""
    if str(precision) in ("bf16", "16", "bfloat16"):
        return torch.bfloat16
    if str(precision) in ("fp32", "32", "float32"):
        return torch.float32
    raise ValueError(f"unknown precision {precision!r}: expected bf16 or fp32")


def configure_backends(compute_dtype: torch.dtype) -> None:
    """Make fp32 compute exact fp32 on the card.

    The JAX fp32 path is exact fp32 math, but PyTorch runs fp32 convolutions
    through cuDNN in TF32 by default (about three decimal digits). So fp32
    compute turns TF32 off for cuDNN and keeps matmuls at "highest". These are
    process-wide flags; bf16 compute does not read them."""
    if compute_dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
