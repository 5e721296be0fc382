"""The precision of the reference's conv and dense operands.

`operand(t)` is the identity in the reference's own precision (fp32, TF32
off: `configure_backends`). Inside `operand_format("fp8")` it rounds `t` to
float8 e4m3 with a per-tensor scale (amax to 448), the precision one step
below the bf16 that the configurations state. The trunk's convolutions and
dense layers take it on their inputs, weights and outputs, its GroupNorms on
their outputs and its residual blocks on their sums, so its activations are
stored in fp8 wherever the port stores them in bf16: that is the
control the comparisons that decide `correct` must fail. The gradient
passes straight through the rounding.
"""

from __future__ import annotations

import contextlib

import torch

# the format in force: a process-wide setting, not a context variable, since
# the backward pass (and a checkpointed block's recompute in it) runs on the
# autograd engine's own threads
_FORMAT = {"name": "fp32"}
FP8_MAX = 448.0  # the largest float8 e4m3fn value


def configure_backends() -> None:
    """Exact fp32: no TF32 in matmuls or convolutions, deterministic cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def operand_format(name: str):
    if name not in ("fp32", "fp8"):
        raise ValueError(f"operand format {name!r}: expected fp32 or fp8")
    before, _FORMAT["name"] = _FORMAT["name"], name
    try:
        yield
    finally:
        _FORMAT["name"] = before


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def operand(t: torch.Tensor) -> torch.Tensor:
    if _FORMAT["name"] == "fp32":
        return t
    return t + (fp8_round(t) - t).detach()
