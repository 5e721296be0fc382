"""Import a published diffusers `AutoencoderKL` into the port's `BaseVAE`.

The KL autoencoders that latent-diffusion models ship (Stable Diffusion 3's
and FLUX.1's `vae/`, config `config/models.py:KL_F8_C16`) are stored in
diffusers' layout; the port keeps the LDM codec's (nn/encoder_decoder.py).
`diffusers_name` gives each port key its diffusers name:

  * `{encoder,decoder}.norm_out` -> `conv_norm_out`;
  * encoder `down.{i}.block.{j}` -> `down_blocks.{i}.resnets.{j}`, and
    `down.{i}.downsample.conv` -> `down_blocks.{i}.downsamplers.0.conv`;
  * decoder `up.{i}` (indexed by level, as the LDM codec is) ->
    `up_blocks.{L-1-i}` (in the order the decoder runs them), `block.{j}`
    -> `resnets.{j}`, `upsample.conv` -> `upsamplers.0.conv`;
  * `mid.block_1` / `mid.block_2` -> `mid_block.resnets.0` / `.1`;
    `mid.attn_1.{norm,q,k,v,proj_out}` ->
    `mid_block.attentions.0.{group_norm,to_q,to_k,to_v,to_out.0}`, whose
    weights are Linear (C, C) where the port's are 1x1 convs (C, C, 1, 1);
  * a res block's 1x1 `nin_shortcut` -> `conv_shortcut`.

Attention inside a level (`attn_resolutions`) and linear attention have no
diffusers counterpart and are refused, as are `quant_conv` /
`post_quant_conv` (SD 1.x's VAE), which the port's BaseVAE does not have:
`convert_diffusers_state_dict` raises KeyError on a key of either side that
the other lacks and ValueError on a shape mismatch, so a partial import
cannot pass silently. No weights are fetched here; a caller reads the
published file (safetensors) into a dict of tensors first.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0"}


def _block(rest: list) -> str:
    return ".".join("conv_shortcut" if p == "nin_shortcut" else p for p in rest)


def _mid(parts: list) -> str:
    if parts[0] in ("block_1", "block_2"):
        return f"mid_block.resnets.{int(parts[0][-1]) - 1}.{_block(parts[1:])}"
    if parts[0] == "attn_1" and parts[1] in _ATTN:
        return f"mid_block.attentions.0.{_ATTN[parts[1]]}.{parts[2]}"
    raise KeyError(f"no diffusers name for mid.{'.'.join(parts)}")


def diffusers_name(key: str, levels: int) -> str:
    """The diffusers AutoencoderKL name of the port's state_dict key `key`
    of a codec with `levels` levels (len(ch_mult)); KeyError for a key with
    no counterpart."""
    side, *parts = key.split(".")
    if side not in ("encoder", "decoder") or not parts:
        raise KeyError(f"no diffusers name for {key}")
    if parts[0] in ("conv_in", "conv_out"):
        return key
    if parts[0] == "norm_out":
        return f"{side}.conv_norm_out.{'.'.join(parts[1:])}"
    if parts[0] == "mid":
        return f"{side}.{_mid(parts[1:])}"
    if side == "encoder" and parts[0] == "down":
        i, kind = parts[1], parts[2]
        if kind == "block":
            return f"encoder.down_blocks.{i}.resnets.{parts[3]}.{_block(parts[4:])}"
        if kind == "downsample":
            return f"encoder.down_blocks.{i}.downsamplers.0.{'.'.join(parts[3:])}"
    if side == "decoder" and parts[0] == "up":
        k, kind = levels - 1 - int(parts[1]), parts[2]
        if kind == "block":
            return f"decoder.up_blocks.{k}.resnets.{parts[3]}.{_block(parts[4:])}"
        if kind == "upsample":
            return f"decoder.up_blocks.{k}.upsamplers.0.{'.'.join(parts[3:])}"
    raise KeyError(f"no diffusers name for {key}")


def _names(model: torch.nn.Module) -> Dict[str, str]:
    """{port key: diffusers key} over `model`'s state_dict."""
    levels = len(model.encoder.down)
    return {k: diffusers_name(k, levels) for k in model.state_dict()}


def convert_diffusers_state_dict(state_dict: Mapping[str, torch.Tensor],
                                 model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The port's state_dict for the BaseVAE `model` (built from a config
    that matches the published one, e.g. `KL_F8_C16`) from a diffusers
    AutoencoderKL state dict, every tensor fp32 on the CPU; load it with
    `model.load_state_dict`. Raises KeyError where a key of either is not
    matched and ValueError where a shape differs."""
    names = _names(model)
    target = model.state_dict()
    unknown = sorted(set(state_dict) - set(names.values()))
    missing = sorted(set(names.values()) - set(state_dict))
    if unknown or missing:
        raise KeyError(f"diffusers state dict does not match the model: unknown {unknown[:8]} "
                       f"({len(unknown)}), missing {missing[:8]} ({len(missing)})")
    out = {}
    for key, name in names.items():
        value = torch.as_tensor(state_dict[name]).detach().to("cpu", torch.float32)
        want = tuple(target[key].shape)
        if value.dim() == 2 and len(want) == 4:  # Linear (C, C) -> 1x1 conv (C, C, 1, 1)
            value = value[:, :, None, None]
        if tuple(value.shape) != want:
            raise ValueError(f"{name} -> {key}: shape {tuple(value.shape)}, the model wants {want}")
        out[key] = value
    return out
