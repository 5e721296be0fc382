"""Ahead-of-time model export with torch.export (counterpart of
medvae_tpu/serve/export.py, which serializes jax.export graphs).

The deterministic reconstruction graph and the sampling graph are traced at
a fixed batch size, with the weights inside, and saved by torch.export; an
artifact runs without the model's Python classes. The kernels of the serving
path stay in the graph as the torch.library ops `medvae::flash_attention`
(B1), `medvae::attention_fwd` (B4) and, with MEDVAE_FUSED_GN=1 at export
time, `medvae::gn_swish_fwd` (B6): the switch is read while tracing, so the
graph keeps the choice, and `meta.json` records it. Loading needs only this
package's ops registered (`load_exported` imports them).

Artifact layout (directory):
  reconstruct.pt2   reconstruct(x_u8, modality_idx), with the whole model's weights
  sample.pt2        sample(noise, modality_idx), with the weights decoding reads
  meta.json         family, resolution, channels, batch sizes, latent shape,
                    device, MEDVAE_FUSED_GN, the medvae:: ops of each graph

The I/O is the JAX package's: uint8 NHWC images and int32 modality indices
in, float32 NHWC out (the engine's output, serve/engine.py:encode_batch and
decode_batch: the posterior mean decoded, not clamped); the ConditionalVAE
takes a one-hot of its `cond_dim`; sample takes explicit float32 noise of
the latent's shape, which the flagship shifts by (idx − 2)·0.3.
"""

from __future__ import annotations

import collections
import copy
import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from medvae_tpu_torch.serve.engine import (
    decode_batch, encode_batch, input_channels, latent_dim, resolve_device, sample_batch,
)

GRAPHS = ("reconstruct", "sample")
# the members of the families that only encoding reads: the encoder, the
# ConditionalVAE's condition map / embedding / FiLM layers, the flagship's
# input projectors
_ENCODE_ONLY = ("encoder", "condition_proj", "condition_embedding", "film_", "in_proj_")


def _decoding_part(model):
    """A shallow copy of `model` without its encode-only members, sharing the
    rest, so that the sample graph's artifact holds only the weights
    sampling reads."""
    part = copy.copy(model)
    part._modules = {k: v for k, v in model._modules.items() if not k.startswith(_ENCODE_ONLY)}
    part._parameters = {k: v for k, v in model._parameters.items()
                        if not k.startswith(_ENCODE_ONLY)}
    return part


class _Reconstruct(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x_u8: torch.Tensor, midx: torch.Tensor) -> torch.Tensor:
        mean, _ = encode_batch(self.model, x_u8, midx)
        return decode_batch(self.model, mean, midx)


class _Sample(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = _decoding_part(model)

    def forward(self, noise: torch.Tensor, midx: torch.Tensor) -> torch.Tensor:
        return sample_batch(self.model, noise.shape[0], midx, noise=noise)


def medvae_ops(program: torch.export.ExportedProgram) -> Dict[str, int]:
    """{"medvae.<op>": nodes} of an exported graph."""
    targets = (str(node.target).split(".") for node in program.graph.nodes if node.op == "call_function")
    counts = collections.Counter(".".join(t[:2]) for t in targets if t[0] == "medvae")
    return dict(sorted(counts.items()))


def export_model(model, out_dir: str, batch_size: int = 8,
                 sample_batch_size: Optional[int] = None) -> Dict[str, Any]:
    """Trace reconstruct at `batch_size` and sample at `sample_batch_size`
    (`batch_size` by default) of a serving model (config/models.py
    build_model with train=False: eval mode, no grads) on the model's
    device, save both and meta.json into `out_dir`; returns the meta.
    Tracing runs under no_grad, so the attention and GN+SiLU sites take
    their serving ops and never the training Functions."""
    if model.training or any(p.requires_grad for p in model.parameters()):
        raise ValueError("export_model takes a serving model: eval mode, params without grads "
                         "(config.models.build_model(..., train=False))")
    dev = next(model.parameters()).device
    res = int(model.resolution)
    cin, zdim = input_channels(model), latent_dim(model)
    r = int(model.encoder_out_res)
    n_sample = int(sample_batch_size or batch_size)
    inputs = {
        "reconstruct": (_Reconstruct(model), torch.zeros((batch_size, res, res, cin), dtype=torch.uint8,
                                                         device=dev)),
        "sample": (_Sample(model), torch.zeros((n_sample, r, r, zdim), dtype=torch.float32, device=dev)),
    }
    os.makedirs(out_dir, exist_ok=True)
    ops = {}
    for name in GRAPHS:
        module, x = inputs[name]
        midx = torch.zeros((x.shape[0],), dtype=torch.int32, device=dev)
        with torch.no_grad():
            program = torch.export.export(module, (x, midx))
        torch.export.save(program, os.path.join(out_dir, f"{name}.pt2"))
        ops[name] = medvae_ops(program)
    meta = {
        "model": type(model).__name__,
        "resolution": res,
        "input_channels": cin,
        "batch_size": int(batch_size),
        "sample_batch_size": n_sample,
        "latent_shape": [r, r, zdim],
        "device": dev.type,
        "fused_gn": os.environ.get("MEDVAE_FUSED_GN") == "1",
        "ops": ops,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def load_exported(out_dir: str, device: Any = "cuda") -> Dict[str, Any]:
    """Load an artifact onto `device` (the card by default; raises where
    there is none, and for an artifact exported for another device type).
    Returns {"reconstruct", "sample": numpy-in, numpy-out callables,
    "programs": the ExportedPrograms, "meta"}."""
    from medvae_tpu_torch.ops import attention, flash_attention, groupnorm_swish  # noqa: F401 (the ops)

    dev = resolve_device(device)
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if dev.type != meta["device"]:
        raise ValueError(f"{out_dir} was exported on {meta['device']}; load it there, or export "
                         f"again on {dev.type}")
    dtypes = {"reconstruct": (np.uint8, np.int32), "sample": (np.float32, np.int32)}
    out: Dict[str, Any] = {"meta": meta, "programs": {}}

    def runner(name: str, program: torch.export.ExportedProgram) -> Callable:
        module = program.module()

        @torch.inference_mode()
        def run(*arrays):
            args = [torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
                    for a, dtype in zip(arrays, dtypes[name])]
            return module(*args).cpu().numpy()

        return run

    for name in GRAPHS:
        program = torch.export.load(os.path.join(out_dir, f"{name}.pt2"))
        out["programs"][name] = program
        out[name] = runner(name, program)
    return out
