"""Attention dispatch for the VAE attention blocks.

Counterpart of medvae_tpu/ops/attention.py (`reference_attention`, and the
routing of `fused_attention_or_none` → `flash_attention_or_none` in
medvae_tpu/ops/flash_attention.py:47-57,118-142).

`attention(q, k, v)` sends a (b, n, c) problem to the flash kernels exactly
where the JAX package does on a TPU, and everything else to
`reference_attention`. Under autograd the flash route is `FlashAttention`
(B1 with lse, then B2 and B3 backward); without it, the lse-free serving
launch of B1. `reference_attention` differentiates through autograd. The
gate is kept for routing parity — the same blocks take the same path in both
packages — until an H100 measurement in PERF.md sets the port's own. The whole-sequence Pallas kernel of the JAX package
(`_attention_fwd_kernel`) is reached by no shipped config and is not ported
yet (ROADMAP queue B).
"""

from __future__ import annotations

import torch

from medvae_tpu_torch.ops.flash_attention import FlashAttention, flash_attention

# The JAX package's routing constants (medvae_tpu/ops/attention.py:21,42-43
# and medvae_tpu/ops/flash_attention.py:41-44).
_MIN_TOKENS = 128
_MIN_CHANNELS = 64
_FUSED_VMEM_BUDGET = 10 * 1024 * 1024
_MAX_BLOCK = 512
_MIN_BLOCK = 256
_LANES = 128
_KERNEL_MAX_CHANNELS = 1024  # csrc/flash_fwd.cu and flash_bwd.cu take c <= 1024


def _pick_block(n: int, max_block: int = _MAX_BLOCK) -> int | None:
    """Largest divisor of n that is <= max_block and a multiple of 16."""
    for d in range(min(n, max_block), 15, -1):
        if d % 16 == 0 and n % d == 0:
            return d
    return None


def uses_flash(n: int, c: int) -> bool:
    """True where the JAX package's TPU dispatch runs its flash kernel:
    past the whole-sequence kernel's envelope, c a multiple of 128 and a
    x16 divisor of n between 256 and 512 rows. The JAX gate's VMEM estimate
    (medvae_tpu/ops/flash_attention.py:88-108) is a Mosaic limit and is not
    kept; the kernel's own limit, c <= 1024, takes its place. Routing
    differs only where that estimate would refuse: among the shipped shapes,
    fp32 at 3136 x 512, which the TPU sends to the einsum path and the port
    to the fp32 kernel."""
    if n < _MIN_TOKENS or c < _MIN_CHANNELS:
        return False
    if (7 * n * c + 3 * n * n) * 4 <= _FUSED_VMEM_BUDGET:
        return False  # the whole-sequence kernel's envelope, not flash
    if c % _LANES != 0 or c > _KERNEL_MAX_CHANNELS:
        return False
    blk = _pick_block(n)
    return blk is not None and blk >= _MIN_BLOCK


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention: fp32 logits of the input-dtype operands, softmax,
    weights cast to v's dtype before P·V with fp32 accumulation.

    The operands are widened to fp32 for both products; a bf16 value is
    exact in fp32, so this is the JAX einsum with preferred fp32 output."""
    c = q.shape[-1]
    scale = torch.tensor(float(c), dtype=torch.float32) ** -0.5
    w = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale.to(q.device)
    w = torch.softmax(w, dim=-1)
    return torch.matmul(w.to(v.dtype).float(), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(b, n, c) single-head attention, routed like the JAX package's TPU path."""
    _, n, c = q.shape
    if not uses_flash(n, c):
        return reference_attention(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    return flash_attention(q, k, v)
