"""Single-head flash attention: the CUDA kernels B1-B3, their plain versions,
and the autograd Function that trains through them.

Counterparts of medvae_tpu/ops/flash_attention.py:
  * B1 `_flash_fwd_kernel` -> csrc/flash_fwd.cu: O, and with `want_lse` the
    (b, n) fp32 row logsumexp the backward reads (the TPU's lane-replicated
    (b, n, 128) carrier is not copied). bf16 with c % 128 == 0 and c <= 512
    takes its Hopper instance (wgmma, TMA), other bf16 shapes its mma.sync
    one (`flash_fwd_instance` says which);
  * B2 `_flash_dkv_kernel` (dK, dV) and B3 `_flash_dq_kernel` (dQ) ->
    csrc/flash_bwd.cu, both behind one wrapper, `flash_bwd`, one count. bf16
    takes the Hopper instance ("wgmma_tma"): pass (a) forms S and dP once
    into bf16 P and dS planes (a (2, b, n_pad, n_pad) scratch the wrapper
    allocates, `plane_shape`), pass (b) forms dQ, dK and dV as wgmma
    products over them. fp32 takes the FMA kernels B2 then B3 ("fp32_fma");
    `flash_bwd_instance` says which;
  * the `jax.custom_vjp` around them -> `FlashAttention`: forward B1 with lse,
    backward delta = rowsum(dO * O) in plain PyTorch, then `flash_bwd`.
The kernels are built by ops/_build.py at first use.

Every wrapper takes (b, n, c) tensors. On CUDA tensors it launches its kernel
(bf16 or fp32) or raises; it uses the plain PyTorch version only for tensors on
the CPU. Each launch adds one to that kernel's count in `launches`. The
serving forward, `flash_attention`, is the torch.library op
`medvae::flash_attention`, so that torch.export keeps it as one node with a
fake (shape-only) implementation; the training Function calls the raw
wrappers.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

# kernel launches by kernel; chip_smoke.py resets and reads them around the
# main path
launches = {"flash_fwd": 0, "flash_bwd": 0}
_count_lock = threading.Lock()

_SUPPORTED = (torch.bfloat16, torch.float32)
# kernel -> (csrc library, C symbol prefix, number of pointer arguments)
_KERNELS = {
    "flash_fwd": ("flash_fwd", "medvae_flash_fwd", 5),
    "flash_bwd": ("flash_bwd", "medvae_flash_bwd", 10),
}
_fns = {}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _kernel(name: str, dtype: torch.dtype):
    fn = _fns.get((name, dtype))
    if fn is None:
        from medvae_tpu_torch.ops import _build

        lib_name, symbol, n_ptrs = _KERNELS[name]
        fn = getattr(_build.load(lib_name), symbol + ("_bf16" if dtype == torch.bfloat16 else "_f32"))
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[(name, dtype)] = fn
    return fn


def _launch(name: str, tensors, q: torch.Tensor) -> None:
    """Launch kernel `name` on q's device and current stream with the data
    pointers of `tensors` (None passes a null pointer)."""
    b, n, c = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(name, q.dtype)(
            *(None if t is None else t.data_ptr() for t in tensors),
            b, n, c, float(c) ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches[name] += 1


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """What the kernels take: (b, n, c) operands of one shape, dtype (bf16 or
    fp32) and device, c a multiple of 64 up to 1024, contiguous and 16-byte
    aligned. `more` are further operands of the same kind (dO)."""
    ops = (q, k, v, *more)
    if q.dim() != 3 or any(t.shape != q.shape for t in ops):
        raise ValueError(
            f"flash_attention expects q, k, v of one shape (b, n, c); got "
            f"{[tuple(t.shape) for t in ops]}"
        )
    if any(t.dtype != q.dtype for t in ops) or q.dtype not in _SUPPORTED:
        raise TypeError(
            f"flash_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{[t.dtype for t in ops]}"
        )
    if any(t.device != q.device for t in ops):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    _, n, c = q.shape
    if n < 1 or c < 64 or c > 1024 or c % 64:
        raise ValueError(
            f"flash_attention kernel takes c a multiple of 64 up to 1024 and "
            f"n >= 1; got n={n}, c={c}"
        )
    for name, t in zip(("q", "k", "v", "dO"), ops):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and 16-byte aligned")


def _check_rows(q: torch.Tensor, **rows: torch.Tensor) -> None:
    """Row statistics (lse, delta): contiguous (b, n) fp32 on q's device."""
    for name, t in rows.items():
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(
                f"flash attention backward: {name} must be (b, n) fp32 on {q.device}; "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"flash attention backward: {name} must be contiguous")


def _cuda_only(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")


# ------------------------------------------------------------------ B1 ---- #


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's function in PyTorch: fp32 logits, softmax numerator exp(s - max)
    cast to the input dtype before P·V with fp32 accumulation, divided by the
    fp32 row sum at the end; and the (b, n) fp32 lse = max + log(sum)."""
    c = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (float(c) ** -0.5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """B1's function without the lse (the serving path's plain version)."""
    return flash_attention_fwd_plain(q, k, v)[0]


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, want_lse: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(O, lse) through kernel B1; lse is None unless `want_lse`."""
    if _on_cpu(q, k, v):
        o, lse = flash_attention_fwd_plain(q, k, v)
        return o, (lse if want_lse else None)
    _check(q, k, v)
    _cuda_only(q)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device) if want_lse else None
    _launch("flash_fwd", (q, k, v, out, lse), q)
    return out, lse


def flash_fwd_instance(c: int, dtype: torch.dtype) -> str:
    """Which instance of B1 a CUDA launch at head dim c takes: "wgmma_tma"
    (the Hopper instance), "mma_sync" (bf16 shapes it does not take) or
    "fp32_fma". Asks the built library, where the choice is made."""
    if dtype == torch.float32:
        return "fp32_fma"
    from medvae_tpu_torch.ops import _build

    fn = _build.load("flash_fwd").medvae_flash_fwd_bf16_instance
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return "wgmma_tma" if fn(int(c)) else "mma_sync"


@torch.library.custom_op("medvae::flash_attention", mutates_args=(), device_types=("cpu", "cuda"))
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ·c^-½)·v for (b, n, c) q, k, v through kernel B1, with no
    lse (the serving launch) and no gradient: the op `medvae::flash_attention`,
    one node of a torch.export graph. Its kernel is `flash_attention_fwd` on
    contiguous copies of the operands: B1's launch on the card (raising where
    B1 does not take them, counted in `launches` when a graph runs), the
    plain version on the CPU. A graph's run may hand the op other strides
    than its trace saw (ops/groupnorm_swish.py:gn_swish_fwd), hence the
    copies; the output is contiguous."""
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), want_lse=False)[0]


@flash_attention.register_fake
def _flash_attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


# ------------------------------------------------------------- B2, B3 ---- #


def _p_ds_plain(q, k, v, g, lse, delta):
    """fp32 P = exp(S - lse) and dS = P (dP - delta) scale, as B2 and B3 form them."""
    scale = float(q.shape[-1]) ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_dkv_plain(q, k, v, g, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's function in PyTorch: dK = dSᵀ·Q and dV = Pᵀ·dO, with P and dS
    cast to the input dtype before the products, fp32 accumulation, outputs
    in the input dtype."""
    p, ds = _p_ds_plain(q, k, v, g, lse, delta)
    dt = q.dtype
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g.float())
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2), q.float())
    return dk.to(dt), dv.to(dt)


def flash_dq_plain(q, k, v, g, lse, delta) -> torch.Tensor:
    """B3's function in PyTorch: dQ = dS·K, dS cast to the input dtype first."""
    _, ds = _p_ds_plain(q, k, v, g, lse, delta)
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


def plane_shape(b: int, n: int) -> Tuple[int, int, int, int]:
    """Shape of the Hopper instance's scratch: the P and dS planes of b batch
    elements, n padded to a multiple of 64 both ways (rows are queries,
    columns keys)."""
    n_pad = (n + 63) // 64 * 64
    return (2, b, n_pad, n_pad)


def flash_bwd_planes_plain(q, k, v, g, lse, delta) -> torch.Tensor:
    """Pass (a) of the Hopper instance in PyTorch: P and dS as B2 and B3 form
    them, cast to the input dtype into a `plane_shape` tensor, zero outside
    n x n."""
    b, n, _ = q.shape
    p, ds = _p_ds_plain(q, k, v, g, lse, delta)
    planes = torch.zeros(plane_shape(b, n), dtype=q.dtype, device=q.device)
    planes[0, :, :n, :n] = p
    planes[1, :, :n, :n] = ds
    return planes


def flash_bwd_grads_plain(planes, q, k, g) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass (b) of the Hopper instance in PyTorch: (dQ, dK, dV) = (dS·K,
    dSᵀ·Q, Pᵀ·dO) from the planes, fp32 accumulation, outputs in the input
    dtype. Composed with `flash_bwd_planes_plain` it is `flash_dq_plain` and
    `flash_dkv_plain` bit for bit: the same fp32 products of the same
    operands, laid out alike."""
    n, dt = q.shape[1], q.dtype
    p = planes[0, :, :n, :n].float().contiguous()
    ds = planes[1, :, :n, :n].float().contiguous()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), g.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_bwd_instance(c: int, dtype: torch.dtype) -> str:
    """Which instance of the backward a CUDA call takes: "wgmma_tma" (the
    Hopper instance) for bf16, "fp32_fma" for fp32, at every c the kernels
    take (`_check`)."""
    return "wgmma_tma" if dtype == torch.bfloat16 else "fp32_fma"


def flash_bwd(q, k, v, g, lse, delta) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of B2 and B3; g is dO, lse from B1, delta = rowsum(dO·O).
    On CUDA tensors one launch of the instance `flash_bwd_instance` names.
    The Hopper instance writes P and dS to a transient `plane_shape` scratch
    of q's dtype: 4·b·pad64(n)² bytes, quadratic in n (1.26 GB at (32, 3136,
    512)), where the fp32 instance needs none. On the CPU the two passes'
    plain versions."""
    if _on_cpu(q, k, v, g, lse, delta):
        return flash_bwd_grads_plain(flash_bwd_planes_plain(q, k, v, g, lse, delta), q, k, g)
    _check(q, k, v, g)
    _check_rows(q, lse=lse, delta=delta)
    _cuda_only(q)
    planes = None
    if q.dtype == torch.bfloat16:
        planes = torch.empty(plane_shape(*q.shape[:2]), dtype=q.dtype, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", (q, k, v, g, lse, delta, dq, dk, dv, planes), q)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q·kᵀ·c^-½)·v with a flash backward: the port of the JAX
    package's custom_vjp (medvae_tpu/ops/flash_attention.py:145-170)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the grad that comes back through proj_out and the token transpose
        # need not be contiguous; the kernels take contiguous operands
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        return flash_bwd(q, k, v, do, lse, delta)
