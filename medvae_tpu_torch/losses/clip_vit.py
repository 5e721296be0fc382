"""CLIP ViT-B/32 image tower (counterpart of medvae_tpu/losses/clip_vit.py:25-109).

32×32 patch conv without bias → class token + learned positional embedding →
`ln_pre` → pre-LN blocks (width 768, 12 heads, 12 layers) → `ln_post` on the
class token → `proj` to 512, all in fp32 (the input is cast on entry); the
LayerNorms take eps 1e-5 and GELU is exact. Module and parameter names are
the JAX package's (`patch_embed`, `block_{i}.attn.qkv`, …), so that
compat/jax_params.py maps its params one to one. NHWC in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MHSA(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.heads
        hd = d // h
        # the Dense output is read as (3, heads, head_dim), as in JAX :35-37
        q, k, v = self.qkv(x).reshape(b, n, 3, h, hd).unbind(2)  # (b, n, h, hd)
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd**-0.5)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, d)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MHSA(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_fc(self.ln2(x)), approximate="none")
        return x + self.mlp_proj(h)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = self.patch_embed(x.float().permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2)  # (b, tokens - 1, width), row-major grid
        cls = self.class_embedding[None, None, :].expand(b, 1, self.width)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding
        h = self.ln_pre(h)
        for i in range(self.layers):
            h = getattr(self, f"block_{i}")(h)
        h = self.ln_post(h[:, 0])
        return h @ self.proj
