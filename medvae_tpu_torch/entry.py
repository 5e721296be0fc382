"""Entry point of the port (counterpart of __graft_entry__.entry,
__graft_entry__.py:16-46).

`entry()` returns `(fn, example_args)`: the training forward of the 28² quick
flagship DisentangledConditionalVAE (5 modalities, hidden 32, ch_mult 1-2-4,
one res block, no attention, latent 8 + 8), bf16, random weights from seed 0,
on the card unless `device` says otherwise.
`fn(params, x, modality_idx, noise) -> (reconstruction, mean, logvar)` runs
the model with `params` (a state_dict) through torch.func.functional_call;
`noise` is the reparameterization draw, where the JAX function takes a PRNG
key. The multi-chip dryrun is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from medvae_tpu_torch.config.models import build_model, init_weights

ENTRY_MODEL: Dict[str, Any] = {
    "_target_": "medvae_tpu.models.DisentangledConditionalVAE",
    "num_modalities": 5,
    "shared_latent_dim": 8,
    "modality_latent_dim": 8,
    "hidden_channels": 32,
    "ch_mult": [1, 2, 4],
    "num_res_blocks": 1,
    "attn_resolutions": [],
    "dropout": 0.0,
    "resolution": 28,
}


def entry(device: Any = "cuda") -> Tuple[Callable, tuple]:
    """(fn, (params, x, modality_idx, noise)) with an (8, 28, 28, 3) bf16
    zero image, modalities [0, 1, 2, 3, 4, 0, 1, 2] and standard-normal
    (8, 7, 7, 16) noise from numpy seed 0."""
    model = init_weights(build_model(ENTRY_MODEL, "bf16", device), seed=0)
    params = dict(model.state_dict())
    x = torch.zeros((8, 28, 28, 3), dtype=torch.bfloat16, device=device)
    midx = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2], dtype=torch.int32, device=device)
    r, zdim = model.encoder_out_res, model.total_latent_dim
    noise = torch.from_numpy(np.random.RandomState(0).randn(8, r, r, zdim).astype(np.float32))

    def fn(params, x, midx, noise):
        out = torch.func.functional_call(model, params, (x, midx), {"noise": noise.to(x.device)})
        return out["reconstruction"], out["mean"], out["logvar"]

    return fn, (params, x, midx, noise.to(device))
