"""Fused Adam / AdamW on the card: the clip's global norm and the update of
every parameter in a few multi-tensor launches (csrc/adamw.cu).

The plain version is train/optim.py's chain, `Optimizer.apply` (zero_nans,
the clip by the global norm, the moments and the update) followed by the
step's `p += u * lr_scale`: ~27 elementwise PyTorch launches a tensor. On the
card the route below moves each byte once:

  * `global_norm_` — `adamw_sumsq` launches write one fp64 partial sum of
    squares a block (NaN read as 0, ±inf kept) into the workspace, and one
    `adamw_norm` launch sums them in a fixed order into the workspace's 0-d
    fp32 norm: no atomics, the same bits on every run, within rounding of
    `global_norm` over the NaN-zeroed gradients;
  * `update_` — `adamw_update` launches read g, m, v, p once and write m, v,
    p once, in the plain chain's op order, each operation rounded as
    PyTorch's separate fp32 kernels round it: given the plain chain's norm,
    m, v and p equal the plain chain's bit for bit.

A launch takes up to `MAX_TENSORS` tensors, cut into chunks of `CHUNK`
elements, one block a chunk; its pointers and sizes are the launch's
arguments, so it reads nothing from the host and a CUDA graph
(train/multistep.py) captures it whole. The learning rate, the bias
corrections and `lr_scale` are the 0-d device tensors the step fills before
it runs. A `Workspace` (the partials and the norm) is made once a parameter
set, by `Optimizer.apply_` at its first fused update (a step's eager warm-up,
before any capture), so the route allocates nothing a step.

`fused_route` decides, from what the call can observe: kind adam or adamw,
the clip's norm the plain `global_norm` (tensor parallelism swaps in its
own), and every g, m, v, p an fp32 tensor of its param's shape on one CUDA
device, m, v and p contiguous. A strided gradient (a convolution's weight
gradient where its input was channels-last, as in the flagship's encoders)
is copied to contiguous memory first, one read and one write of it.
Everything else (SGD, the CPU, bf16 tensors, strided params or moments)
takes the plain chain. The library is built by ops/_build.py at first use,
so the module imports without nvcc. Each launch adds one to its kernel's
count in `launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import torch

from medvae_tpu_torch.core import tracing

# kernel launches by kernel; core/tracing.py's counters() holds them as
# launches.<kernel>, and train/multistep.py counts them under graph replay
launches = {"adamw_sumsq": 0, "adamw_norm": 0, "adamw_update": 0}
_count_lock = threading.Lock()
tracing.register("launches", launches, _count_lock)

CHUNK = 65536  # elements a block (csrc/adamw.cu's kChunk)
MAX_TENSORS = 64  # tensors a launch (kMaxTensors)
KINDS = ("adam", "adamw")

_fns = {}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def least_bytes(numel: int, clip: bool) -> int:
    """The least bytes one update of `numel` fp32 params moves: g, m, v and p
    read and m, v and p written once (28 B an element), and g read once more
    for the clip's norm (4 B)."""
    return numel * (32 if clip else 28)


def fused_route(kind: str, plain_norm: bool, grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                nu: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> bool:
    """True where the kernels take the update: `kind` adam or adamw, the
    clip's norm the plain global norm (`plain_norm`), as many g, m, v as
    params, and every one an fp32 tensor of its param's shape on the params'
    device, a CUDA device; m, v and p contiguous (`adam_` copies a strided
    g)."""
    if kind not in KINDS or not plain_norm or not params:
        return False
    if not len(grads) == len(mu) == len(nu) == len(params):
        return False
    device = params[0].device
    if device.type != "cuda" or not _fits(grads, device, contiguous=False):
        return False
    if not all(_fits(group, device) for group in (mu, nu, params)):
        return False
    return all(g.shape == m.shape == v.shape == p.shape for g, m, v, p in zip(grads, mu, nu, params))


def _fits(tensors: Sequence[torch.Tensor], device: torch.device, contiguous: bool = True) -> bool:
    return all(t.dtype is torch.float32 and t.device == device and (t.is_contiguous() or not contiguous)
               for t in tensors)


def _blocks(n: int) -> int:
    return -(-n // CHUNK)


@dataclasses.dataclass
class Workspace:
    """The route's scratch for one parameter set: its launches (each a run of
    at most MAX_TENSORS non-empty tensors by index, and the run's first
    block), the blocks in all, one fp64 partial a block and the 0-d fp32
    norm, on the params' device."""

    sizes: Tuple[int, ...]
    groups: List[Tuple[List[int], int]]
    blocks: int
    partials: torch.Tensor
    norm: torch.Tensor

    @classmethod
    def of(cls, params: Sequence[torch.Tensor]) -> "Workspace":
        sizes = tuple(p.numel() for p in params)
        nonempty = [i for i, n in enumerate(sizes) if n]
        groups, blocks = [], 0
        for lo in range(0, len(nonempty), MAX_TENSORS):
            idx = nonempty[lo:lo + MAX_TENSORS]
            groups.append((idx, blocks))
            blocks += sum(_blocks(sizes[i]) for i in idx)
        device = params[0].device
        return cls(sizes, groups, blocks, torch.zeros((max(blocks, 1),), dtype=torch.float64, device=device),
                   torch.zeros((), dtype=torch.float32, device=device))

    def fits(self, params: Sequence[torch.Tensor]) -> bool:
        return (len(params) == len(self.sizes) and self.norm.device == params[0].device
                and all(p.numel() == n for p, n in zip(params, self.sizes)))


def _lib():
    if not _fns:
        from medvae_tpu_torch.ops import _build

        lib = _build.load("adamw")
        vp, ll, f = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float
        sumsq, norm, update = lib.medvae_adamw_sumsq, lib.medvae_adamw_norm, lib.medvae_adamw_update
        sumsq.argtypes = [vp, ll, ctypes.c_int, vp, vp]
        norm.argtypes = [vp, ctypes.c_int, vp, vp]
        update.argtypes = [vp, vp, vp, vp, ll, ctypes.c_int, vp] + [f] * 7 + [ctypes.c_int] + [vp] * 5
        for fn in (sumsq, norm, update):
            fn.restype = ctypes.c_int
        _fns.update(adamw_sumsq=sumsq, adamw_norm=norm, adamw_update=update)
    return _fns


def _ptrs(tensors: Sequence[torch.Tensor], idx: List[int]):
    return (ctypes.c_void_p * len(idx))(*[tensors[i].data_ptr() for i in idx])


def _sizes(ws: Workspace, idx: List[int]):
    return (ctypes.c_longlong * len(idx))(*[ws.sizes[i] for i in idx])


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launched(name: str, err: int) -> None:
    """Count a launch of kernel `name`, or raise on its launcher's error."""
    if err != 0:
        from medvae_tpu_torch.ops import _build

        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({_build.last_failure('adamw')})")
    with _count_lock:
        launches[name] += 1


def global_norm_(grads: Sequence[torch.Tensor], ws: Workspace) -> torch.Tensor:
    """sqrt of the sum of squares of every element of `grads`, NaN read as 0,
    into `ws.norm` (returned): the `adamw_sumsq` launches and `adamw_norm`.
    `grads` are tensors that `fused_route` takes, of `ws`'s sizes."""
    fns, device = _lib(), ws.norm.device
    with torch.cuda.device(device):
        stream = _stream(device)
        for idx, first in ws.groups:
            partials = ws.partials.data_ptr() + 8 * first
            err = fns["adamw_sumsq"](_ptrs(grads, idx), _sizes(ws, idx), len(idx), partials, stream)
            _launched("adamw_sumsq", err)
        if ws.blocks:
            err = fns["adamw_norm"](ws.partials.data_ptr(), ws.blocks, ws.norm.data_ptr(), stream)
            _launched("adamw_norm", err)
        else:
            ws.norm.zero_()
    return ws.norm


@dataclasses.dataclass(frozen=True)
class Hyper:
    """An update's constants as Python floats (each cast to fp32 as PyTorch
    casts a Python scalar operand) and its 0-d fp32 device scalars."""

    b1: float
    b2: float
    eps: float
    weight_decay: float
    decay: bool  # AdamW's decoupled decay
    neg_lr: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    lr_scale: torch.Tensor
    clip: Optional[float] = None


def update_(grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
            params: Sequence[torch.Tensor], ws: Workspace, h: Hyper, norm: Optional[torch.Tensor] = None) -> None:
    """m, v and p advanced in place by the `adamw_update` launches, clipped
    by `norm` (a 0-d fp32 device tensor) where `h.clip` is set. The tensors
    are ones that `fused_route` takes, of `ws`'s sizes."""
    if h.clip and norm is None:
        raise ValueError("adamw: a clipped update needs the norm")
    for t in (norm, h.neg_lr, h.bc1, h.bc2, h.lr_scale):
        if t is not None and (t.dtype is not torch.float32 or t.device != ws.norm.device or t.numel() != 1):
            raise ValueError("adamw: the norm and scalars are 0-d fp32 tensors on the params' device")
    fns, device = _lib(), ws.norm.device
    scalars = [t.data_ptr() for t in (h.neg_lr, h.bc1, h.bc2, h.lr_scale)]
    consts = [h.clip or 0.0, 1.0 - h.b1, h.b1, 1.0 - h.b2, h.b2, h.eps, h.weight_decay]
    with torch.cuda.device(device):
        stream = _stream(device)
        for idx, _ in ws.groups:
            err = fns["adamw_update"](_ptrs(grads, idx), _ptrs(mu, idx), _ptrs(nu, idx), _ptrs(params, idx),
                                      _sizes(ws, idx), len(idx), norm.data_ptr() if h.clip else None, *consts,
                                      int(h.decay), *scalars, stream)
            _launched("adamw_update", err)


def adam_(grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
          params: Sequence[torch.Tensor], ws: Workspace, h: Hyper) -> None:
    """One clipped (where `h.clip` is set) Adam / AdamW update on the card:
    `global_norm_`, then `update_`, strided gradients copied to contiguous
    memory first. The caller has taken `fused_route`."""
    grads = [g.contiguous() for g in grads]
    norm = global_norm_(grads, ws) if h.clip else None
    update_(grads, mu, nu, params, ws, h, norm)
