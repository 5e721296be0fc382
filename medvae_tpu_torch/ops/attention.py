"""Attention for the VAE attention blocks: the dispatch, the whole-sequence
CUDA kernels B4 (forward) and B5 (backward), their plain versions and the
autograd Function that trains through them.

Counterpart of medvae_tpu/ops/attention.py (`fused_attention_or_none`, the
`fused_attention` custom_vjp over `_attention_fwd_kernel` and
`_attention_bwd_kernel`, `reference_attention`) and of the routing to
medvae_tpu/ops/flash_attention.py:47-57,118-142.

`attention(q, k, v)` sends a (b, n, c) problem where the JAX package sends it
on a TPU:
  * `uses_fused(n, c)`, the whole-sequence envelope (n >= 128, c >= 64 and the
    TPU's VMEM estimate within 10 MiB): `FusedAttention` under autograd (B4,
    then B5 backward), else the op `medvae::attention_fwd` (B4);
  * `uses_flash(n, c)`, past that envelope: `FlashAttention` (B1 with lse,
    B2, B3) under autograd, else the op `medvae::flash_attention` (B1's
    serving launch);
  * everything else: `reference_attention`, which differentiates through
    autograd.
The gates are kept for routing parity (the same blocks take the same path in
both packages) until an H100 measurement in PERF.md sets the port's own.

B4 and B5 keep the TPU kernels' fp32 arithmetic: fp32 logits, the exact
softmax (max, exp, sum, divide), products with P and dS at fp32 fidelity, and
each output cast to the input dtype once. They are built from
csrc/attention.cu by ops/_build.py at first use, in two instances
(`attention_instance` says which a shape takes): bf16 with c % 64 == 0 and
n <= 256, every shape of the main path, takes the Hopper instance
("wgmma_tma": tensor-core products, P and dS as three bf16 terms each); every
other shape, and fp32, the FMA instance ("fma"). On CUDA tensors the wrappers
launch their kernel or raise; they use the plain PyTorch versions only for
tensors on the CPU. Each call adds one to its kernel's count in `launches`
(one for B5, which takes two CUDA launches). The serving forward is the
torch.library op `medvae::attention_fwd` (`attention_fwd`), so that
torch.export keeps it as one node; the training Function calls the raw
wrappers.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from medvae_tpu_torch.ops.flash_attention import FlashAttention, flash_attention

# kernel calls by kernel; chip_smoke.py resets and reads them around the main
# path
launches = {"attention_fwd": 0, "attention_bwd": 0}
_count_lock = threading.Lock()

# The JAX package's routing constants (medvae_tpu/ops/attention.py:21,42-43
# and medvae_tpu/ops/flash_attention.py:41-44).
_MIN_TOKENS = 128
_MIN_CHANNELS = 64
_FUSED_VMEM_BUDGET = 10 * 1024 * 1024
_MAX_BLOCK = 512
_MIN_BLOCK = 256
_LANES = 128
_KERNEL_MAX_CHANNELS = 1024  # csrc/flash_fwd.cu and flash_bwd.cu take c <= 1024

_SUPPORTED = (torch.bfloat16, torch.float32)
# kernel -> (C symbol prefix, number of pointer arguments)
_KERNELS = {"attention_fwd": ("medvae_attention_fwd", 4),
            "attention_bwd": ("medvae_attention_bwd", 8)}
_fns = {}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _pick_block(n: int, max_block: int = _MAX_BLOCK) -> int | None:
    """Largest divisor of n that is <= max_block and a multiple of 16."""
    for d in range(min(n, max_block), 15, -1):
        if d % 16 == 0 and n % d == 0:
            return d
    return None


def _vmem_estimate(n: int, c: int) -> int:
    """The TPU backward's working set: seven (n, c) and three (n, n) fp32
    tensors (medvae_tpu/ops/attention.py:31-34)."""
    return (7 * n * c + 3 * n * n) * 4


def uses_fused(n: int, c: int) -> bool:
    """True where the JAX package's TPU dispatch runs its whole-sequence
    kernel: n >= 128, c >= 64 and the VMEM estimate within 10 MiB
    (medvae_tpu/ops/attention.py:54-63). The port's kernels take every such
    shape (n <= 863 there)."""
    return n >= _MIN_TOKENS and c >= _MIN_CHANNELS and _vmem_estimate(n, c) <= _FUSED_VMEM_BUDGET


def uses_flash(n: int, c: int) -> bool:
    """True where the JAX package's TPU dispatch runs its flash kernel:
    past the whole-sequence kernel's envelope, c a multiple of 128 and a
    x16 divisor of n between 256 and 512 rows. The JAX gate's VMEM estimate
    (medvae_tpu/ops/flash_attention.py:88-108) is a Mosaic limit and is not
    kept; the kernel's own limit, c <= 1024, takes its place. Routing
    differs only where that estimate would refuse: among the shipped shapes,
    fp32 at 3136 x 512, which the TPU sends to the einsum path and the port
    to the fp32 kernel."""
    if n < _MIN_TOKENS or c < _MIN_CHANNELS or uses_fused(n, c):
        return False
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
    # c^-½ in fp32, as a CPU scalar operand: no host-to-device copy, which a
    # captured step (train/multistep.py) could not take
    scale = torch.tensor(float(c), dtype=torch.float32) ** -0.5
    w = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(w, dim=-1)
    return torch.matmul(w.to(v.dtype).float(), v.float()).to(q.dtype)


# --------------------------------------------------------------- B4, B5 ---- #


def _kernel(name: str, dtype: torch.dtype):
    fn = _fns.get((name, dtype))
    if fn is None:
        from medvae_tpu_torch.ops import _build

        symbol, n_ptrs = _KERNELS[name]
        fn = getattr(_build.load("attention"), symbol + ("_bf16" if dtype == torch.bfloat16 else "_f32"))
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[(name, dtype)] = fn
    return fn


@functools.lru_cache(maxsize=None)
def fused_max_tokens() -> int:
    """The largest n the kernels take, as csrc/attention.cu works it out from
    its shared memory: a block's (n, BM) fp32 P and dS and its tiles (past
    the gate's largest n, 863). Builds the library."""
    from medvae_tpu_torch.ops import _build

    fn = _build.load("attention").medvae_attention_max_tokens
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def attention_instance(n: int, c: int, dtype: torch.dtype) -> str:
    """Which instance of B4 and B5 a CUDA launch at (n, c) takes: "wgmma_tma"
    (the Hopper instance: bf16, c % 64 == 0, n <= 256) or "fma". Asks the
    built library, where the choice is made."""
    if dtype != torch.bfloat16:
        return "fma"
    from medvae_tpu_torch.ops import _build

    fn = _build.load("attention").medvae_attention_bf16_instance
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return "wgmma_tma" if fn(int(n), int(c)) else "fma"


def _bwd_scratch(q: torch.Tensor) -> torch.Tensor:
    """B5's scratch, sized by the library for the instance (b, n, c) takes:
    the Hopper instance's bf16 planes of P and dS, or the FMA instance's row
    max, sum and delta."""
    from medvae_tpu_torch.ops import _build

    fn = _build.load("attention").medvae_attention_bwd_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    nbytes = fn(*q.shape, int(q.dtype == torch.bfloat16))
    return torch.empty((nbytes,), dtype=torch.uint8, device=q.device)


def _launch(name: str, tensors, q: torch.Tensor) -> None:
    b, n, c = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name, q.dtype)(
            *(t.data_ptr() for t in tensors), b, n, c, float(c) ** -0.5, stream,
        )
    if err != 0:
        from medvae_tpu_torch.ops import _build

        raise RuntimeError(f"{name} kernel launch failed (code {err}): {_build.last_failure('attention')}")
    with _count_lock:
        launches[name] += 1


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(*ops: torch.Tensor) -> None:
    """What the kernels take: contiguous, 16-byte aligned (b, n, c) operands
    of one shape, dtype (bf16 or fp32) and CUDA device, n up to
    `fused_max_tokens()`."""
    q = ops[0]
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    if q.dim() != 3 or any(t.shape != q.shape for t in ops):
        raise ValueError(
            f"fused_attention expects operands of one shape (b, n, c); got "
            f"{[tuple(t.shape) for t in ops]}"
        )
    if q.dtype not in _SUPPORTED or any(t.dtype != q.dtype for t in ops):
        raise TypeError(f"fused_attention takes bf16 or fp32 operands of one dtype; got "
                        f"{[t.dtype for t in ops]}")
    if any(t.device != q.device for t in ops):
        raise ValueError("fused_attention: operands lie on different devices")
    b, n, c = q.shape
    if not (1 <= b <= 65535 and 1 <= n <= fused_max_tokens() and c >= 1):
        raise ValueError(f"fused_attention kernels take b <= 65535 and n <= {fused_max_tokens()}; "
                         f"got b={b}, n={n}, c={c}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ops):
        raise ValueError("fused_attention: operands must be contiguous and 16-byte aligned")


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 input (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def fused_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """B4's function in PyTorch (medvae_tpu/ops/attention.py:100-118): q, k,
    v widened to fp32, logits scaled by c^-½, the row max subtracted, exp,
    divided by the row sum, P·V in fp32, cast to the input dtype."""
    c, acc = q.shape[-1], _acc_dtype(q)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * (float(c) ** -0.5)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v.to(acc)).to(q.dtype)


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5's function in PyTorch, with the TPU kernel's explicit formulas
    (medvae_tpu/ops/attention.py:136-180), all in fp32: recompute P; dv =
    Pᵀ·g, dp = g·vᵀ, dlogits = P∘(dp − Σⱼ dp∘P), dq = dlogits·k·c^-½, dk =
    dlogitsᵀ·q·c^-½; each cast to its input's dtype."""
    scale = float(q.shape[-1]) ** -0.5
    qf, kf, vf, gf = (t.to(_acc_dtype(q)) for t in (q, k, v, g))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    dlogits = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(dlogits, kf) * scale
    dk = torch.matmul(dlogits.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ·c^-½)·v for (b, n, c) q, k, v through kernel B4."""
    if _on_cpu(q, k, v):
        return fused_attention_fwd_plain(q, k, v)
    _check(q, k, v)
    out = torch.empty_like(q)
    _launch("attention_fwd", (q, k, v, out), q)
    return out


@torch.library.custom_op("medvae::attention_fwd", mutates_args=(), device_types=("cpu", "cuda"))
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """B4 as the op `medvae::attention_fwd`, the serving forward: one node of
    a torch.export graph. Its kernel is `fused_attention_fwd` on contiguous
    copies of the operands (B4's launch on the card, raising, counted; the
    plain version on the CPU), as `flash_attention`'s is."""
    return fused_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous())


@attention_fwd.register_fake
def _attention_fwd_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through kernel B5; g is the gradient of the output."""
    if _on_cpu(q, k, v, g):
        return fused_attention_bwd_plain(q, k, v, g)
    _check(q, k, v, g)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("attention_bwd", (q, k, v, g, dq, dk, dv, _bwd_scratch(q)), q)
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """softmax(q·kᵀ·c^-½)·v with B4 forward and B5 backward: the port of the
    JAX package's `fused_attention` custom_vjp, whose residuals are only q,
    k and v (medvae_tpu/ops/attention.py:66-81)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return fused_attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # the gradient that comes back through proj_out and the token
        # transpose need not be contiguous; the kernels take contiguous operands
        return fused_attention_bwd(q, k, v, g.to(q.dtype).contiguous())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(b, n, c) single-head attention, routed like the JAX package's TPU path."""
    _, n, c = q.shape
    training = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if uses_fused(n, c):
        return FusedAttention.apply(q, k, v) if training else attention_fwd(q, k, v)
    if uses_flash(n, c):
        return FlashAttention.apply(q, k, v) if training else flash_attention(q, k, v)
    return reference_attention(q, k, v)
