"""The reference's model of a configuration: a frozen copy of the port's
config/models.py class table, every param in fp32 and computing in fp32."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from portbench.reference.base_vae import BaseVAE
from portbench.reference.conditional_vae import ConditionalVAE
from portbench.reference.disentangled_conditional_vae import DisentangledConditionalVAE
from portbench.reference.encoder_decoder import set_remat
from portbench.reference.operands import configure_backends

_CODEC_KEYS = (
    "hidden_channels", "ch_mult", "num_res_blocks", "attn_resolutions", "resolution", "double_z",
    "dropout", "use_linear_attn", "attn_type",
)
_BASE_KEYS = ("input_channels", "latent_dim") + _CODEC_KEYS
_MODELS = {
    "BaseVAE": (BaseVAE, _BASE_KEYS),
    "ConditionalVAE": (ConditionalVAE, _BASE_KEYS + ("modalities", "condition_dim", "condition_method",
                                                     "num_modalities")),
    "DisentangledConditionalVAE": (DisentangledConditionalVAE,
                                   ("num_modalities", "shared_latent_dim", "modality_latent_dim") + _CODEC_KEYS),
}


def build(model_cfg: Mapping[str, Any], device, train: bool = True, remat: Any = False) -> BaseVAE:
    """The model of `model_cfg` on `device` (the meta device for shapes
    alone), fp32, in train mode with grads (or eval mode without);
    `remat` checkpoints its blocks, which saves memory and changes no
    number."""
    cfg: Dict[str, Any] = dict(model_cfg)
    target = str(cfg.get("_target_", "DisentangledConditionalVAE")).rsplit(".", 1)[-1]
    cls, keys = _MODELS[target]
    configure_backends()
    with torch.device(device):
        model = cls(**{k: cfg[k] for k in keys if k in cfg})
    set_remat(model, remat)
    if train:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)
