"""Load the JAX package's parameters (and gradients) into the port.

`from_jax_params(params, model)` takes a JAX param tree (the `params`
collection, as nested dicts of numpy arrays — no JAX needed) and returns a
state_dict for `model`: the VAE, or a frozen loss tower (LPIPSNet,
SimpleCLIPEncoder, CLIPViT, whose module names are the JAX package's):

  * conv kernels HWIO -> OIHW (the grouped `heads_conv2` kernel (3,3,C,M·C)
    becomes (M·C, C, 3, 3), the same transpose; CLIP's `patch_embed` has no
    bias);
  * Dense kernels (in, out) -> Linear weights (out, in);
  * norm and LayerNorm `scale` -> `weight`, `bias` -> `bias`;
  * codec module names -> the reference torch layout, the inverse of
    medvae_tpu/compat/torch_import.py:46-62: `down_{i}_block_{j}` ->
    `down.{i}.block.{j}`, `down_{i}_attn_{j}` -> `down.{i}.attn.{j}`,
    `down_{i}_downsample` -> `down.{i}.downsample`, `mid_block_1` ->
    `mid.block_1`, `mid_attn_1` -> `mid.attn_1`; `up_…` alike; a linear
    attention block's `attn/to_qkv` and `attn/to_out` lose the `attn`
    (the reference's LinAttnBlock is a LinearAttention);
  * the ConditionalVAE's conditioning keeps the flax names: `temb_proj` in
    the encoder's res blocks, `film_{i}.{scale,shift}_transform`,
    `condition_embedding.layers_{0,2}` (Dense kernels, as above);
  * top-level params keep the JAX package's names and layout: the VAE's
    projectors (`in_proj_kernel_{m}`, …), LPIPS's `lin{i}`, CLIP's
    `class_embedding`, `positional_embedding` and `proj` (a plain (in, out)
    matrix used as x @ proj in both).

`from_jax_grads(grads, model)` maps a JAX gradient tree, which has the
params' structure, onto the model's parameter names the same way.

`from_jax_disc_variables(variables, disc)` takes a JAX PatchGAN's variables
(`params` and, without `use_actnorm`, `batch_stats`) and returns the port
discriminator's state_dict: the params by the rules above (`conv{n}` kernels
HWIO -> OIHW, `norm{n}` scale -> weight), and each `norm{n}`'s batch-stat
`mean` and `var` onto its `running_mean` and `running_var` buffers.

Every JAX leaf is mapped exactly once and shape-checked against the model;
an unmapped leaf, a target the model lacks, a shape mismatch or a model
tensor left uncovered raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

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


# how a JAX leaf's value becomes the torch tensor
_AXES = {"conv": (3, 2, 0, 1), "dense": (1, 0), None: None}


def _target(path: Tuple[str, ...], ndim: int) -> Tuple[str, Optional[str]]:
    """(torch name, transform: "conv", "dense" or None)."""
    *mods, leaf = path
    if not mods:  # top-level params keep their names
        return leaf, None
    if mods[0] in ("encoder", "decoder") and len(mods) > 1:
        rest = mods[2:]
        if "attn" in mods[1] and rest[:1] == ["attn"]:
            rest = rest[1:]  # LinAttnBlock's LinearAttention, a flax submodule, is its torch base class
        mods = [mods[0], *_codec_module(mods[1]), *rest]
    if leaf == "kernel" and ndim in (2, 4):
        return ".".join([*mods, "weight"]), "conv" if ndim == 4 else "dense"
    if leaf == "scale":
        return ".".join([*mods, "weight"]), None
    if leaf == "bias":
        return ".".join([*mods, "bias"]), None
    raise KeyError(f"JAX param {'/'.join(path)} has no rule in the port")


def _permute(shape: Tuple[int, ...], transform: Optional[str]) -> Tuple[int, ...]:
    axes = _AXES[transform]
    return shape if axes is None else tuple(shape[a] for a in axes)


def plan_jax_params(
    params: Mapping[str, Any], expected: Mapping[str, Tuple[int, ...]]
) -> List[Tuple[Tuple[str, ...], str, Optional[str]]]:
    """Map every leaf of `params` (anything with `.shape`) onto the torch
    names of `expected` ({name: shape}); returns (jax path, torch name,
    transform) triples after checking names, shapes and coverage."""
    plan, seen = [], {}
    for path, leaf in _flatten(params):
        shape = tuple(leaf.shape)
        name, transform = _target(path, len(shape))
        if name in seen:
            raise KeyError(f"{'/'.join(path)} and {'/'.join(seen[name])} both map to {name}")
        seen[name] = path
        if name not in expected:
            raise KeyError(f"JAX param {'/'.join(path)} -> {name}: no such tensor in the port")
        want = tuple(expected[name])
        got = _permute(shape, transform)
        if got != want:
            raise ValueError(f"{'/'.join(path)} -> {name}: shape {got} vs port {want}")
        plan.append((path, name, transform))
    left = sorted(set(expected) - set(seen))
    if left:
        raise KeyError(f"port tensors with no JAX param: {left[:8]}{' …' if len(left) > 8 else ''}")
    return plan


def _convert(tree: Mapping[str, Any], expected: Mapping[str, Tuple[int, ...]]):
    flat = dict(_flatten(tree))
    out = {}
    for path, name, transform in plan_jax_params(tree, expected):
        value = np.asarray(flat[path], np.float32)
        axes = _AXES[transform]
        out[name] = torch.tensor(value if axes is None else value.transpose(axes))
    return out


def leaf_to_torch(
    path: Tuple[str, ...], value: np.ndarray, expected: Mapping[str, Tuple[int, ...]]
) -> Optional[Tuple[str, torch.Tensor]]:
    """(torch name, fp32 tensor) for one JAX leaf at `path`, or None when the
    leaf has no rule or `expected` ({name: shape}) has no such tensor. The
    value is first reshaped to the JAX layout of the target, as a graft of
    exported weights reshapes to the param's shape, then laid out for torch."""
    try:
        name, _ = _target(path, 4)  # the name does not depend on the rank
    except KeyError:
        return None
    if name not in expected:
        return None
    want = tuple(expected[name])
    transform = None
    if path[-1] == "kernel" and len(path) > 1 and len(want) in (2, 4):
        transform = "conv" if len(want) == 4 else "dense"
    axes = _AXES[transform]
    jax_shape = want if axes is None else tuple(want[axes.index(i)] for i in range(len(want)))
    value = np.asarray(value, np.float32).reshape(jax_shape)
    return name, torch.tensor(value if axes is None else value.transpose(axes))


def from_jax_params(params: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """state_dict (fp32 CPU tensors) for `model` from the JAX param tree."""
    return _convert(params, {k: tuple(v.shape) for k, v in model.state_dict().items()})


def from_jax_grads(grads: Mapping[str, Any], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: fp32 CPU tensor} from a JAX gradient tree of the
    model's params, laid out as the port's parameters are."""
    return _convert(grads, {k: tuple(v.shape) for k, v in model.named_parameters()})


def from_jax_disc_variables(variables: Mapping[str, Any], disc: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """state_dict (fp32 CPU tensors) for the port's NLayerDiscriminator from
    a JAX NLayerDiscriminator's variables; see the module docstring."""
    out = _convert(variables["params"], {k: tuple(v.shape) for k, v in disc.named_parameters()})
    buffers = {k: tuple(v.shape) for k, v in disc.named_buffers()}
    stats = {f"{'.'.join(path[:-1])}.running_{path[-1]}": value
             for path, value in _flatten(variables.get("batch_stats", {}))}
    if set(stats) != set(buffers):
        raise KeyError(f"JAX batch_stats {sorted(stats)} vs port buffers {sorted(buffers)}")
    for name, value in stats.items():
        value = np.asarray(value, np.float32)
        if value.shape != buffers[name]:
            raise ValueError(f"{name}: shape {value.shape} vs port {buffers[name]}")
        out[name] = torch.tensor(value)
    return out
