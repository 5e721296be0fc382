"""Port checkpoints (counterpart of medvae_tpu/cli/common.py).

A port checkpoint is one `torch.save`d dict
`{"state_dict": ..., "model": <model config dict>, "precision": "bf16"|"fp32"}`.
The trainer's snapshots (train/checkpoint.py) are directories holding one in
`checkpoint.pt`, with the train state beside it; every loader here takes the
file or such a directory.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import torch

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


def load_model(path: str, device: Any = "cuda") -> torch.nn.Module:
    """Build the checkpoint's model on `device` and load its weights."""
    ckpt = load_checkpoint(path)
    model = build_model(ckpt["model"], ckpt["precision"], device)
    model.load_state_dict(ckpt["state_dict"])
    return model
