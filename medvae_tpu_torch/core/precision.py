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


def configure_backends() -> None:
    """Make fp32 math exact fp32 on the card, and repeatable.

    The JAX fp32 math is exact, but PyTorch runs fp32 convolutions through
    cuDNN in TF32 by default (about three decimal digits). The port's fp32
    math is the fp32 compute path and the loss towers, which compute in fp32
    under bf16 compute too. So every model and tower build turns TF32 off for
    cuDNN and keeps fp32 matmuls at "highest". The flags are process-wide;
    setting them the same way on every build keeps a process's numerics
    independent of what it built before. bf16 math does not read them.

    It also keeps cuDNN to deterministic algorithms: without that the fp32
    convolutions' backward (the loss towers', the discriminator's) may add
    with atomics, so two identical GAN steps on the card differed in nearly
    every gradient, and a resumed GAN run drifted from the uninterrupted one
    (2.9e-3 relative L2 in the generator after 18 steps on an H100)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
