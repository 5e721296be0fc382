"""Load the JAX package's parameters into the port.

`from_jax_params(params, model)` takes the JAX model's param tree (the
`params` collection, as nested dicts of numpy arrays — no JAX needed) and
returns a state_dict for `model`:

  * conv kernels HWIO -> OIHW (the grouped `heads_conv2` kernel (3,3,C,M·C)
    becomes (M·C, C, 3, 3), the same transpose);
  * norm `scale` -> `weight`, `bias` -> `bias`;
  * codec module names -> the reference torch layout, the inverse of
    medvae_tpu/compat/torch_import.py:46-62: `down_{i}_block_{j}` ->
    `down.{i}.block.{j}`, `down_{i}_attn_{j}` -> `down.{i}.attn.{j}`,
    `down_{i}_downsample` -> `down.{i}.downsample`, `mid_block_1` ->
    `mid.block_1`, `mid_attn_1` -> `mid.attn_1`; `up_…` alike;
  * the fused heads (`heads_conv1/2`) and the projector params
    (`in_proj_kernel_{m}`, …) keep the JAX package's names and layout.

Every JAX leaf is mapped exactly once and shape-checked against the model;
an unmapped leaf, a target the model lacks, a shape mismatch or a model
tensor left uncovered raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

_LEVEL = re.compile(r"^(down|up)_(\d+)_(block|attn)_(\d+)$")
_RESAMPLE = re.compile(r"^(down|up)_(\d+)_(downsample|upsample)$")
_MID = re.compile(r"^mid_((?:block|attn)_\d+)$")


def _codec_module(name: str) -> List[str]:
    m = _LEVEL.match(name)
    if m:
        return [m[1], m[2], m[3], m[4]]
    m = _RESAMPLE.match(name)
    if m:
        return [m[1], m[2], m[3]]
    m = _MID.match(name)
    if m:
        return ["mid", m[1]]
    return [name]


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _target(path: Tuple[str, ...], ndim: int) -> Tuple[str, bool]:
    """(torch name, whether the value is an HWIO kernel to transpose)."""
    *mods, leaf = path
    if not mods:  # top-level projector params keep their names
        return leaf, False
    if mods[0] in ("encoder", "decoder") and len(mods) > 1:
        mods = [mods[0], *_codec_module(mods[1]), *mods[2:]]
    if leaf == "kernel" and ndim == 4:
        return ".".join([*mods, "weight"]), True
    if leaf == "scale":
        return ".".join([*mods, "weight"]), False
    if leaf == "bias":
        return ".".join([*mods, "bias"]), False
    raise KeyError(f"JAX param {'/'.join(path)} has no rule in the port")


def plan_jax_params(
    params: Mapping[str, Any], expected: Mapping[str, Tuple[int, ...]]
) -> List[Tuple[Tuple[str, ...], str, bool]]:
    """Map every leaf of `params` (anything with `.shape`) onto the torch
    names of `expected` ({name: shape}); returns (jax path, torch name,
    transpose) triples after checking names, shapes and coverage."""
    plan, seen = [], {}
    for path, leaf in _flatten(params):
        shape = tuple(leaf.shape)
        name, transpose = _target(path, len(shape))
        if name in seen:
            raise KeyError(f"{'/'.join(path)} and {'/'.join(seen[name])} both map to {name}")
        seen[name] = path
        if name not in expected:
            raise KeyError(f"JAX param {'/'.join(path)} -> {name}: no such tensor in the port")
        want = tuple(expected[name])
        got = (shape[3], shape[2], shape[0], shape[1]) if transpose else shape
        if got != want:
            raise ValueError(f"{'/'.join(path)} -> {name}: shape {got} vs port {want}")
        plan.append((path, name, transpose))
    left = sorted(set(expected) - set(seen))
    if left:
        raise KeyError(f"port tensors with no JAX param: {left[:8]}{' …' if len(left) > 8 else ''}")
    return plan


def from_jax_params(params: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """state_dict (fp32 CPU tensors) for `model` from the JAX param tree."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    flat = dict(_flatten(params))
    out = {}
    for path, name, transpose in plan_jax_params(params, expected):
        value = np.asarray(flat[path], np.float32)
        if transpose:
            value = value.transpose(3, 2, 0, 1)
        out[name] = torch.tensor(value)
    return out
