"""Image resizes as jax.image.resize computes them (the port's copy of its
rules): a weight matrix per spatial axis from the triangle ("linear") or
Keys cubic kernel with a = −0.5 ("cubic"), half-pixel centres, antialiased
when shrinking, weights normalized over the taps inside the image. Applied
as two matrix products, whose backward is a product too, so it repeats bit
for bit on the card, where F.interpolate's bilinear backward adds with
atomics. Each weight matrix is made once per device and dtype and kept
(`_device_matrix`), so a resize of a plain tensor copies nothing from the
host, which a CUDA graph capture of a train step (train/multistep.py) could
not take. A kept matrix is made outside inference mode, whatever mode its
first caller is in: one made under the engine's `torch.inference_mode()`
could not be saved for a later backward in the same process.
"""

from __future__ import annotations

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                   + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


def resize_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) fp32 weights of jax.image.resize along one axis
    (compute_weight_mat, antialias on, no translation)."""
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


_matrices: dict = {}  # (n_in, n_out, method, device, dtype) -> the matrix there


def _device_matrix(n_in: int, n_out: int, method: str, x: torch.Tensor) -> torch.Tensor:
    """`resize_matrix` on x's device in x's dtype, kept for plain tensors;
    a tracer's tensor (torch.export's fake and functional ones) gets a
    matrix of its own trace, never one kept."""
    key = (n_in, n_out, method, x.device, x.dtype)
    if type(x) is torch.Tensor and key in _matrices:
        return _matrices[key]
    with torch.inference_mode(False):
        m = torch.from_numpy(resize_matrix(n_in, n_out, method)).to(x.device, x.dtype)
    if type(x) is torch.Tensor and type(m) is torch.Tensor:
        _matrices[key] = m
    return m


def resize(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """jax.image.resize of NHWC x to `size` (an int for a square, or
    (height, width)) on the spatial axes."""
    _, h, w, _ = x.shape
    out_h, out_w = (size, size) if isinstance(size, int) else size
    if h != out_h:
        x = torch.einsum("bhwc,hH->bHwc", x, _device_matrix(h, out_h, method, x))
    if w != out_w:
        x = torch.einsum("bhwc,wW->bhWc", x, _device_matrix(w, out_w, method, x))
    return x
