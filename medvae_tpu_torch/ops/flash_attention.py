"""Single-head flash-attention forward: the CUDA kernel and its plain version.

Counterpart of medvae_tpu/ops/flash_attention.py:_flash_fwd_kernel with
want_lse=False, the path serving takes (no gradient is traced there, so this
module has no backward and no autograd.Function; the backward kernels come
with the training slice). The kernel is csrc/flash_fwd.cu, built by
ops/_build.py at first use.

`flash_attention(q, k, v)` takes (b, n, c) tensors. On CUDA tensors it
launches the kernel (bf16 or fp32) or raises; it uses the plain PyTorch
version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

launches = 0  # kernel launches; the serving path's phases read and reset it
_count_lock = threading.Lock()

_SUPPORTED = (torch.bfloat16, torch.float32)
_fns = {}


def _kernel(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from medvae_tpu_torch.ops import _build

        lib = _build.load("flash_fwd")
        fn = getattr(
            lib,
            "medvae_flash_fwd_bf16" if dtype == torch.bfloat16 else "medvae_flash_fwd_f32",
        )
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: fp32 logits, softmax numerator
    exp(s - max) cast to the input dtype before P·V with fp32 accumulation,
    divided by the fp32 row sum at the end."""
    c = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (float(c) ** -0.5)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention expects q, k, v of one shape (b, n, c); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUPPORTED:
        raise TypeError(
            f"flash_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    _, n, c = q.shape
    if n < 1 or c < 64 or c > 1024 or c % 64:
        raise ValueError(
            f"flash_attention kernel takes c a multiple of 64 up to 1024 and "
            f"n >= 1; got n={n}, c={c}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ·c^-½)·v for (b, n, c) q, k, v, through the CUDA kernel."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, c = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, c, float(c) ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out
