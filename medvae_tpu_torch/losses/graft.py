"""Graft exported pretrained weights into a frozen loss tower (the port's
copy of medvae_tpu/losses/graft.py:graft_npz's rules).

The npz holds flat Flax keys, `params/a/b/c` → array, as
scripts/export_torch_weights.py writes them for the LPIPS AlexNet trunk and
the CLIP image tower. Each key that names a tensor of the tower is mapped onto
its state_dict through compat/jax_params.py's codec (conv kernels HWIO → OIHW,
Dense kernels transposed, `scale` → `weight`); the rest are reported. A file
that matches nothing raises: a silent no-op graft would train against the
random tower while claiming pretrained weights.
"""

from __future__ import annotations

import numpy as np
import torch

from medvae_tpu_torch.compat.jax_params import leaf_to_torch


@torch.no_grad()
def graft_npz(module: torch.nn.Module, path: str, label: str) -> torch.nn.Module:
    """Load the npz at `path` into `module` in place and return it."""
    state = module.state_dict()
    expected = {k: tuple(v.shape) for k, v in state.items()}
    matched, unmatched = 0, []
    with np.load(path) as z:
        for key in z.files:
            parts = tuple(key.split("/"))
            hit = leaf_to_torch(parts[1:], z[key], expected) if parts[0] == "params" else None
            if hit is None:
                unmatched.append(key)
                continue
            name, value = hit
            state[name].copy_(value)
            matched += 1
    if matched == 0:
        raise ValueError(
            f"weight graft from {path} matched 0 of {len(unmatched)} arrays — wrong file "
            f"or stale export format (expected flat 'params/...' keys)"
        )
    print(f"{label} graft: {matched} arrays loaded from {path}")
    if unmatched:
        print(f"{label} graft: ignored unmatched keys: {unmatched}")
    return module
