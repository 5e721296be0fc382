"""Port checkpoints and run configs (counterpart of medvae_tpu/cli/common.py).

A port checkpoint is one `torch.save`d dict
`{"state_dict": ..., "model": <model config dict>, "precision": "bf16"|"fp32"}`.
The trainer's snapshots (train/checkpoint.py) are directories holding one in
`checkpoint.pt`, with the train state beside it (its EMA weights under
`train_state["ema"]`); every loader here takes the file or such a directory.
The composed run config, which the CLIs read for the data section, lies in
`config.yaml` beside the snapshots (train/trainer.py writes it).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import yaml

from medvae_tpu_torch.config.models import build_model


def save_checkpoint(
    path: str, state_dict: Mapping[str, torch.Tensor], model_cfg: Mapping[str, Any],
    precision: str = "bf16",
) -> None:
    """Write a port checkpoint; tensors are stored on the CPU in fp32."""
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in state_dict.items()}
    torch.save({"state_dict": sd, "model": dict(model_cfg), "precision": str(precision)}, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    missing = {"state_dict", "model", "precision"} - set(ckpt)
    if missing:
        raise ValueError(f"{path} is not a port checkpoint (missing {sorted(missing)})")
    return ckpt


def load_model(path: str, device: Any = "cuda", use_ema: bool = False) -> torch.nn.Module:
    """Build the checkpoint's model on `device` and load its weights.

    `use_ema`: the EMA weight average the Trainer keeps with
    training.ema_decay > 0 (`train_state["ema"]`) replaces the raw params;
    raises if the run kept none."""
    ckpt = load_checkpoint(path)
    state_dict = ckpt["state_dict"]
    if use_ema:
        ema = (ckpt.get("train_state") or {}).get("ema")
        if ema is None:
            raise ValueError(
                f"use_ema requested but checkpoint {path} has no "
                "ema_params (train with training.ema_decay > 0)"
            )
        state_dict = {**state_dict, **ema}
    model = build_model(ckpt["model"], ckpt["precision"], device)
    model.load_state_dict(state_dict)
    return model


def find_run_config(ckpt_path: str, explicit: Optional[str] = None) -> Dict[str, Any]:
    """Locate the composed run config (saved next to the checkpoints)."""
    candidates = [explicit] if explicit else []
    d = os.path.abspath(ckpt_path)
    for up in range(4):
        candidates.append(os.path.join(d, "config.yaml"))
        d = os.path.dirname(d)
    for c in candidates:
        if c and os.path.exists(c):
            with open(c) as f:
                return yaml.safe_load(f)
    raise FileNotFoundError(
        f"No config.yaml found near {ckpt_path}; pass --config explicitly"
    )


def load_model_and_params(
    ckpt_path: str, config_path: Optional[str] = None, use_ema: bool = False,
    device: Any = "cuda",
) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """(model with its weights on `device`, the run config). The model is the
    checkpoint's own (its `model` and `precision`); the config gives the
    CLIs the data section. `use_ema` as in `load_model`."""
    cfg = find_run_config(ckpt_path, config_path)
    return load_model(ckpt_path, resolve_device(device), use_ema=use_ema), cfg


def resolve_device(name: Any = "cuda") -> torch.device:
    """The CLIs' `--device`: `cpu`, or the card for `cuda` (also `gpu`,
    `tpu`), which raises where there is none; never a fallback."""
    name = str(name).lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "gpu", "tpu") and not name.startswith("cuda:"):
        raise ValueError(f"--device {name!r}: expected cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} asks for the card and there is no CUDA device; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name if name.startswith("cuda") else "cuda")


def seeded(device: torch.device, seed: int) -> torch.Generator:
    """A torch.Generator on `device` seeded with `seed` (a `core.rng.fold_in`
    of the CLI's --seed where JAX folds its key)."""
    return torch.Generator(device=device).manual_seed(int(seed))
