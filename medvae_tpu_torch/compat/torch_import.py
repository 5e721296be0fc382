"""Import reference (PyTorch Lightning) checkpoints into the port (the
port's copy of medvae_tpu/compat/torch_import.py's rules).

A user of the reference has `.ckpt` files that its `VAELightningModule`
wrote through Lightning's ModelCheckpoint. `convert_state_dict` turns such a
state dict into the port's, key for key as the JAX importer maps it onto
flax params:

  * the `model.` prefix is stripped; the loss towers, the GAN discriminator
    (`_SKIP_PREFIXES`) and every top-level key the JAX importer has no rule
    for are skipped and reported (`condition_embedding.*` and `film_*`
    among them: the reference declares those modules but never applies
    them, so the port keeps its own init for the inject/film layers, as the
    JAX package keeps flax's);
  * trunk keys (`encoder.*`, `decoder.*`) are the reference's names in the
    port already, linear attention's `to_qkv`/`to_out` included;
  * `condition_proj.{i}.*`, the reference's Sequential(Linear, ReLU,
    Unflatten), becomes the port's Linear `condition_proj.*`;
  * the 1x1-conv `modality_{input,output}_projectors.{m}` become the port's
    `{in,out}_proj_kernel_{m}` (in, out) matrices and `_bias_{m}` vectors;
  * `modality_embedding.*` is skipped when the model has none (the port's
    flagship never does: the reference's forward does not use it);
  * the per-head `modality_decoders.{m}.{0,2}` convs are concatenated into
    `heads_conv1` / `heads_conv2`, head m owning output slice [m·C, (m+1)·C).
An unmatched model key raises KeyError and a shape mismatch ValueError, so
a silent partial import is impossible.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# Lightning-module attributes that are not part of the VAE itself.
_SKIP_PREFIXES = (
    "criterion.",
    "loss.",
    "perceptual_loss.",
    "biomed_clip_loss.",
    "discriminator.",
)


def _fp32(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(value), dtype=torch.float32)


def convert_state_dict(
    state_dict: Mapping[str, Any], model: torch.nn.Module
) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """(the port's state_dict for `model`, report) from a reference Lightning
    state dict of numpy arrays or torch tensors. `model` must be built from
    the checkpoint's model config; its tensors that the checkpoint does not
    name keep their values. report: `mapped` and `skipped` keys, in the
    checkpoint's order. Every tensor comes back fp32 on the CPU."""
    target = model.state_dict()
    out = {k: _fp32(v) for k, v in target.items()}
    mapped: List[str] = []
    skipped: List[str] = []
    heads: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}

    for key, tensor in state_dict.items():
        k = key[len("model."):] if key.startswith("model.") else key
        if k.startswith(_SKIP_PREFIXES) or key.startswith(_SKIP_PREFIXES):
            skipped.append(key)
            continue
        value = _fp32(tensor)
        parts = k.split(".")
        if parts[0] in ("encoder", "decoder"):
            name = k
        elif parts[0] == "condition_proj":
            name = f"condition_proj.{parts[-1]}"
        elif parts[0] in ("modality_input_projectors", "modality_output_projectors"):
            stem = "in_proj" if "input" in parts[0] else "out_proj"
            if parts[-1] == "weight":  # 1x1 conv (out, in, 1, 1) -> (in, out)
                value = value[:, :, 0, 0].t().contiguous()
                name = f"{stem}_kernel_{parts[1]}"
            else:
                name = f"{stem}_bias_{parts[1]}"
        elif parts[0] == "modality_embedding":
            name = "modality_embedding.weight"
            if name not in target:
                skipped.append(key)
                continue
        elif parts[0] == "modality_decoders":
            # ModuleList[m] of Sequential(conv, ReLU, conv)
            conv = "heads_conv1" if parts[2] == "0" else "heads_conv2"
            heads.setdefault((conv, parts[-1]), {})[int(parts[1])] = value
            mapped.append(key)
            continue
        else:
            skipped.append(key)
            continue
        if name not in target:
            raise KeyError(
                f"torch key {key} has no parameter in the target model "
                f"(tried {[name]}) — wrong model config?"
            )
        if tuple(target[name].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch for {key} -> {name}: checkpoint "
                f"{tuple(value.shape)} vs model {tuple(target[name].shape)} — wrong "
                "model config for this checkpoint?"
            )
        out[name] = value
        mapped.append(key)

    for (conv, leaf), per_head in heads.items():
        name = f"{conv}.{leaf}"
        if name not in target:
            raise KeyError(f"no parameter {name} in target model")
        stacked = torch.cat([per_head[m] for m in sorted(per_head)], dim=0)
        if tuple(stacked.shape) != tuple(target[name].shape):
            raise ValueError(
                f"decoder heads {conv}: checkpoint assembles to "
                f"{tuple(stacked.shape)}, model expects {tuple(target[name].shape)}"
            )
        out[name] = stacked
    return out, {"mapped": mapped, "skipped": skipped}


def import_lightning_checkpoint(ckpt_path: str, cfg: Mapping[str, Any], output_dir: str) -> str:
    """Convert a reference Lightning `.ckpt` into a port checkpoint that
    every loader here takes (cli/common.py:load_model, the engine, the eval
    CLIs): `<output_dir>/imported/checkpoint.pt` with the composed `cfg` as
    `<output_dir>/config.yaml`. `cfg`'s `model` section must match the
    checkpoint's architecture. Returns the checkpoint directory."""
    from medvae_tpu_torch.cli.common import save_checkpoint
    from medvae_tpu_torch.config.compose import save_yaml
    from medvae_tpu_torch.config.models import build_model, init_weights

    # Lightning payloads hold pickled hyper-parameters beside the tensors
    payload = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    state_dict = {k: v for k, v in payload.get("state_dict", payload).items() if hasattr(v, "detach")}
    precision = str(cfg.get("precision", "bf16"))
    # fp32 params, so that the reference's values are kept as they are; the
    # tensors no key names take the port's seeded init
    model = init_weights(build_model(cfg["model"], precision, "cpu", train=True), seed=0)
    converted, report = convert_state_dict(state_dict, model)

    ckpt_dir = os.path.abspath(os.path.join(output_dir, "imported"))
    os.makedirs(ckpt_dir, exist_ok=True)
    save_checkpoint(os.path.join(ckpt_dir, "checkpoint.pt"), converted, cfg["model"], precision)
    save_yaml(cfg, os.path.join(output_dir, "config.yaml"))
    n_skip = len(report["skipped"])
    print(
        f"Imported {len(report['mapped'])} tensors from {ckpt_path}"
        + (f" (skipped {n_skip} non-model keys)" if n_skip else "")
    )
    return ckpt_dir
