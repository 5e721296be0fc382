"""Model configs and construction (counterpart of medvae_tpu/train/trainer.py:53-89).

`FLAGSHIP` equals configs/model/disentangled_conditional_vae.yaml as a Python
dict, so that nothing on the serving path needs PyYAML. `CVAE_BENCH` is the
28² ConditionalVAE of bench.py's default step (bench.py:118-129,205-211).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from medvae_tpu_torch.core.precision import compute_dtype_for, configure_backends
from medvae_tpu_torch.models import BaseVAE, BetaVAE, ConditionalVAE, DisentangledConditionalVAE
from medvae_tpu_torch.nn.blocks import Conv2d, set_compute_dtype

FLAGSHIP: Dict[str, Any] = {
    "_target_": "medvae_tpu.models.DisentangledConditionalVAE",
    "latent_dim": 128,
    "shared_latent_dim": 64,
    "modality_latent_dim": 64,
    "hidden_channels": 128,
    "ch_mult": [1, 2, 4, 8],
    "num_res_blocks": 2,
    "attn_resolutions": [28, 56],
    "dropout": 0.0,
    "resolution": 224,
    "use_linear_attn": False,
    "attn_type": "vanilla",
    "double_z": True,
    "num_modalities": 5,
    "modality_separation_weight": 0.1,
    "contrastive_weight": 0.05,
}

CVAE_BENCH: Dict[str, Any] = {
    "_target_": "medvae_tpu.models.ConditionalVAE",
    "input_channels": 3,
    "latent_dim": 16,
    "hidden_channels": 32,
    "ch_mult": [1, 2, 4],
    "num_res_blocks": 1,
    "attn_resolutions": [],
    "resolution": 28,
    "condition_method": "concat",
    "dropout": 0.0,
}

_CODEC_KEYS = (
    "hidden_channels", "ch_mult", "num_res_blocks", "attn_resolutions", "resolution", "double_z",
    "dropout", "use_linear_attn", "attn_type",
)
_BASE_KEYS = ("input_channels", "latent_dim") + _CODEC_KEYS
# class name -> (class, config keys its constructor takes, keys read elsewhere
# or ignored). The flagship's loss weights are training's, and its latent is
# shared + modality whatever `latent_dim` says (the JAX model ignores it too).
_MODELS = {
    "BaseVAE": (BaseVAE, _BASE_KEYS, ()),
    "BetaVAE": (BetaVAE, _BASE_KEYS + ("beta",), ()),
    "ConditionalVAE": (
        ConditionalVAE,
        _BASE_KEYS + ("modalities", "condition_dim", "condition_method", "num_modalities"),
        (),
    ),
    "DisentangledConditionalVAE": (
        DisentangledConditionalVAE,
        ("num_modalities", "shared_latent_dim", "modality_latent_dim") + _CODEC_KEYS,
        ("latent_dim", "modality_separation_weight", "contrastive_weight"),
    ),
}


def build_model(
    model_cfg: Mapping[str, Any],
    precision: str = "bf16",
    device: Any = "cuda",
    train: bool = False,
) -> BaseVAE:
    """Instantiate the model of `model_cfg` (`_target_` BaseVAE, BetaVAE,
    ConditionalVAE or DisentangledConditionalVAE, the flagship when unset) on
    `device` with the precision applied. Params are made in fp32.

    Serving (`train=False`): eval mode, no grads, conv weights stored in the
    compute dtype (rounding them once here equals flax's cast at every call).
    Training (`train=True`): train mode with grads, every param kept in fp32
    and each conv casting weight, bias and input to the compute dtype at every
    call, as flax's `dtype=` does; so the optimizer state is fp32 too. Norm
    and projector params are fp32 in both. Neither needs remat at 224², bs 32
    on an 80 GB card."""
    cfg = dict(model_cfg)
    target = str(cfg.get("_target_", "DisentangledConditionalVAE")).rsplit(".", 1)[-1]
    if target not in _MODELS:
        raise NotImplementedError(f"model {target} is not ported yet")
    cls, keys, unused = _MODELS[target]
    unknown = set(cfg) - set(keys) - set(unused) - {"_target_"}
    if unknown:
        raise ValueError(f"unknown {target} config keys: {sorted(unknown)}")
    compute_dtype = compute_dtype_for(precision)
    configure_backends()
    with torch.device(device):
        model = cls(**{k: cfg[k] for k in keys if k in cfg})
    if train:
        set_compute_dtype(model, compute_dtype)
        return model.train().requires_grad_(True)
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.to(compute_dtype)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Random weights from a seeded CPU torch.Generator, so that every device
    gets the same ones: conv and linear kernels ~ N(0, 1/fan_in) (flax's
    lecun-normal scale), norm scales 1, biases 0."""
    gen = torch.Generator().manual_seed(int(seed))

    def normal(p: torch.Tensor, fan_in: int) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * fan_in**-0.5)

    for module in model.modules():
        if isinstance(module, torch.nn.GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
            normal(module.weight, module.weight[0].numel())
            if module.bias is not None:  # linear attention's to_qkv has none
                module.bias.zero_()
    for p in model.parameters(recurse=False):  # projector (in, out) kernels, biases
        if p.dim() == 2:
            normal(p, p.shape[0])
        else:
            p.zero_()
    return model
