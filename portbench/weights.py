"""Weights made from a seed on the card, for the program and the reference
alike.

`spec(module)` lists every param and buffer of one of the reference's
modules (built on the meta device, so it costs nothing) with how it is
drawn: conv and linear kernels ~ N(0, 1/fan_in), other matrices ~ N(0,
1/rows) (a (in, out) projector), embeddings ~ N(0, 0.02²), LPIPS's `lin`
heads 1/C, norm scales and running variances 1, biases and means 0.
`make(spec, seed, device)` draws every normal value of the spec in one
`torch.randn` on a generator on the device, then scales and splits it: the
same seed gives the same tensors on every call. The program's modules take
them by name through `load`, and so does the reference after the window.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

Entry = Tuple[str, tuple, str, float]  # name, shape, kind ("normal" | "const"), std or value


def spec(module: nn.Module) -> List[Entry]:
    entries: List[Entry] = []
    for mname, m in module.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, p in m.named_parameters(recurse=False):
            name, shape = prefix + pname, tuple(p.shape)
            if isinstance(m, (nn.Conv2d, nn.Linear)) and pname == "weight":
                entries.append((name, shape, "normal", float(p[0].numel()) ** -0.5))
            elif "embed" in pname or "class" in pname:
                entries.append((name, shape, "normal", 0.02))
            elif p.dim() >= 2:
                entries.append((name, shape, "normal", float(shape[0]) ** -0.5))
            elif pname.startswith("lin") and pname[3:].isdigit():
                entries.append((name, shape, "const", 1.0 / shape[0]))
            elif "bias" in pname or "shift" in pname or "mean" in pname:
                entries.append((name, shape, "const", 0.0))
            else:  # a norm's scale
                entries.append((name, shape, "const", 1.0))
        for bname, b in m.named_buffers(recurse=False):
            if not b.is_floating_point():
                continue
            entries.append((prefix + bname, tuple(b.shape), "const", 1.0 if "var" in bname else 0.0))
    return entries


@torch.no_grad()
def make(entries: List[Entry], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = sum(int(torch.Size(shape).numel()) for _, shape, kind, _ in entries if kind == "normal")
    flat = torch.randn((n,), generator=gen, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, shape, kind, v in entries:
        if kind == "normal":
            k = int(torch.Size(shape).numel())
            out[name] = flat[i:i + k].view(shape).mul_(v)
            i += k
        else:
            out[name] = torch.full(shape, v, device=device, dtype=torch.float32)
    return out


@torch.no_grad()
def load(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy `tensors` into `module`'s params and floating buffers by name
    (each cast to the module's storage dtype); every one of them must be
    named, and no more."""
    own = dict(module.named_parameters())
    own.update({k: b for k, b in module.named_buffers() if b.is_floating_point()})
    missing, extra = sorted(set(own) - set(tensors)), sorted(set(tensors) - set(own))
    if missing or extra:
        raise ValueError(f"weights by name: the module lacks {extra[:5]}, the spec lacks {missing[:5]}")
    for name, t in own.items():
        src = tensors[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"weights: {name} is {tuple(t.shape)} in the module, {tuple(src.shape)} in the spec")
        t.copy_(src)
