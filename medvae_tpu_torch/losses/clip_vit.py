"""CLIP ViT-B/32 image tower (counterpart of medvae_tpu/losses/clip_vit.py:25-109).

32×32 patch conv without bias → class token + learned positional embedding →
`ln_pre` → pre-LN blocks (width 768, 12 heads, 12 layers) → `ln_post` on the
class token → `proj` to 512; the LayerNorms take eps 1e-5 and GELU is exact.
`forward(x, dtype)` computes the patch embedding, the dense layers, the
attention's probabilities times V and the GELU in `dtype` (fp32 by default;
bf16 with `loss.tower_dtype: bfloat16`, the frozen params cast once), while the
LayerNorms, the residual stream after `ln_pre`, the attention logits and
softmax and the final projection stay fp32, as in the JAX tower
(medvae_tpu/losses/clip_vit.py:28-56). Module and parameter names are
the JAX package's (`patch_embed`, `block_{i}.attn.qkv`, …), so that
compat/jax_params.py maps its params one to one. NHWC in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _weights(layer: nn.Module, dtype: torch.dtype) -> tuple:
    """`layer`'s weight and bias in `dtype`. A frozen layer (a tower's) keeps
    its cast copies: made once, and again only when its params move or change
    (`load_state_dict` bumps their `_version`), never while a CUDA graph is
    being captured (the copy would hold nothing until a replay). A layer that
    trains casts at every call, inside the autograd graph."""
    w, b = layer.weight, layer.bias
    if w.requires_grad or (b is not None and b.requires_grad):
        return w.to(dtype), None if b is None else b.to(dtype)
    key = (dtype, w.device, w.data_ptr(), w._version, None if b is None else (b.data_ptr(), b._version))
    kept = layer.__dict__.get("_cast_weights")
    if kept is not None and kept[0] == key:
        return kept[1], kept[2]
    with torch.no_grad(), torch.inference_mode(False):
        cast = (w.to(dtype), None if b is None else b.to(dtype))
    if not (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        layer.__dict__["_cast_weights"] = (key, *cast)
    return cast


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer` on x with operands and output in `dtype` (Flax's Conv dtype).
    Below fp32 the bias is added to the rounded product, as Flax adds it
    (two roundings); fp32 keeps the fused call."""
    if dtype == torch.float32:
        return layer(x.float())
    w, b = _weights(layer, dtype)
    y = F.conv2d(x.to(dtype), w, None, layer.stride, layer.padding)
    return y if b is None else y + b[:, None, None]


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer` on x with operands and output in `dtype` (Flax's Dense
    dtype); below fp32 the bias is added to the rounded product."""
    if dtype == torch.float32:
        return layer(x.float())
    w, b = _weights(layer, dtype)
    return F.linear(x.to(dtype), w) + b


_SQRT_HALF_BF16 = 0.70703125  # np.sqrt(0.5) rounded to bf16, as jax.nn.gelu takes it


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in x's dtype. Below fp32 it is jax.nn.gelu's form op by
    op, each result rounded: 0.5 * x * erfc(-x * sqrt(0.5)); F.gelu would
    round once and give other bf16 numbers."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF_BF16)


class MHSA(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        hd = d // h
        # the Dense output is read as (3, heads, head_dim), as in JAX :35-37
        q, k, v = dense(self.qkv, x, dtype).reshape(b, n, 3, h, hd).unbind(2)  # (b, n, h, hd)
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (hd**-0.5)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, d)
        return dense(self.proj, out, dtype)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MHSA(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), dtype)
        h = gelu(dense(self.mlp_fc, self.ln2(x), dtype))
        return x + dense(self.mlp_proj, h, dtype)


class CLIPViT(nn.Module):
    """ViT-B/32 image encoder: (B, image_size, image_size, 3) → (B, embed_dim)."""

    def __init__(
        self,
        patch: int = 32,
        width: int = 768,
        layers: int = 12,
        heads: int = 12,
        embed_dim: int = 512,
        image_size: int = 224,
    ):
        super().__init__()
        self.width = width
        self.layers = layers
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        tokens = (image_size // patch) ** 2 + 1
        self.positional_embedding = nn.Parameter(torch.zeros(tokens, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        for i in range(layers):
            self.add_module(f"block_{i}", Block(width, heads))
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim))

    @torch.no_grad()
    def init_own(self, gen: torch.Generator) -> None:
        """The JAX initializers of the top-level params: normal(0.02) class
        and positional embeddings, normal(width^-½) projection."""
        for p, std in ((self.class_embedding, 0.02), (self.positional_embedding, 0.02),
                       (self.proj, self.width**-0.5)):
            p.copy_(torch.randn(p.shape, generator=gen) * std)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        b = x.shape[0]
        h = conv(self.patch_embed, x.permute(0, 3, 1, 2), dtype)
        h = h.flatten(2).transpose(1, 2)  # (b, tokens - 1, width), row-major grid
        cls = self.class_embedding[None, None, :].expand(b, 1, self.width).to(dtype)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(dtype)
        h = self.ln_pre(h.float())
        for i in range(self.layers):
            h = getattr(self, f"block_{i}")(h, dtype)
        h = self.ln_post(h[:, 0])
        return h @ self.proj
