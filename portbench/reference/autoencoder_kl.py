"""The published KL autoencoder of Stable Diffusion 3 and FLUX.1, in plain
PyTorch and in the diffusers layout, for holding the port (and the frozen
BaseVAE of this directory) to the published description.

Sources: FLUX.1's vae/config.json
(https://huggingface.co/black-forest-labs/FLUX.1-dev/blob/main/vae/config.json),
a diffusers `AutoencoderKL` (in/out channels 3, latent_channels 16,
block_out_channels [128, 256, 512, 512], layers_per_block 2,
norm_num_groups 32, SiLU, mid_block_add_attention true, sample_size 1024,
use_quant_conv and use_post_quant_conv false), and arXiv 2403.03206 (the
improved autoencoder with d = 16 latent channels). `CONFIG` holds those
values. The modules and parameter names are diffusers':

  * `encoder.conv_in`, `encoder.down_blocks.{i}.resnets.{j}` (norm1, conv1,
    norm2, conv2, a 1x1 `conv_shortcut` where the width changes),
    `encoder.down_blocks.{i}.downsamplers.0.conv` (a stride-2 3x3 conv after
    the asymmetric (0, 1, 0, 1) zero pad) on every level but the last,
    `encoder.mid_block` (`resnets.0`, `attentions.0`, `resnets.1`),
    `encoder.conv_norm_out`, SiLU, `encoder.conv_out` to 2 x 16 moments;
  * `decoder.conv_in`, `decoder.mid_block`, `decoder.up_blocks.{k}` in the
    order the decoder runs them (k = 0 the coarsest), layers_per_block + 1
    resnets each, `upsamplers.0.conv` (nearest x2, then a 3x3 conv) on every
    block but the last, `decoder.conv_norm_out`, SiLU, `decoder.conv_out`;
  * the mid block's attention: `group_norm`, Linear `to_q`, `to_k`, `to_v`
    and `to_out.0`, one head over all C channels, scale C^-½, softmax in
    fp32, then the residual;
  * every GroupNorm 32 groups, eps 1e-6, with affine params;
  * the posterior: mean and logvar are the moments' halves, logvar clamped
    to [-30, 20] (diffusers' DiagonalGaussianDistribution); `reconstruct`
    decodes the mean, `forward` decodes mean + exp(½ logvar)·noise.

It computes in fp32; `configure` turns TF32 off, so a matmul or conv is
exact fp32. Departures from the published model: none in the network. Left
to its callers, as diffusers leaves them to the pipelines: the latents'
scaling_factor 0.3611 and shift_factor 0.1159. Dropout is 0 as published
and has no module here. The attention is written out (softmax of q kᵀ·scale,
then ·v) where diffusers calls scaled_dot_product_attention: the same
function.

It imports nothing but torch: no kernel, nothing of the port, nothing of
the benchmark.
"""

import torch
from torch import nn

CONFIG = {
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 16,
    "block_out_channels": (128, 256, 512, 512),
    "layers_per_block": 2,
    "norm_num_groups": 32,
    "mid_block_add_attention": True,
    "sample_size": 1024,
}
EPS = 1e-6  # every GroupNorm's
LOGVAR_RANGE = (-30.0, 20.0)


def configure() -> None:
    """Exact fp32 on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _silu(x):
    return torch.nn.functional.silu(x)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=EPS)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(_silu(self.norm1(x)))
        h = self.conv2(_silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """One head over all channels, with the residual."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=EPS)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)  # (b, h·w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        logits = torch.matmul(q, k.transpose(1, 2)) * c ** -0.5
        out = torch.matmul(torch.softmax(logits.float(), dim=-1).to(v.dtype), v)
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(torch.nn.functional.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(torch.nn.functional.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, c: int, groups: int, attention: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(c, c, groups), ResnetBlock2D(c, c, groups)])
        self.attentions = nn.ModuleList([Attention(c, groups)] if attention else [])

    def forward(self, x):
        x = self.resnets[0](x)
        if len(self.attentions):
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Block(nn.Module):
    """A DownEncoderBlock2D (`downsamplers`) or UpDecoderBlock2D
    (`upsamplers`): `layers` resnets, the first from `cin`."""

    def __init__(self, cin: int, cout: int, layers: int, groups: int, resample=None):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else cout, cout, groups) for j in range(layers)])
        if resample is Downsample2D:
            self.downsamplers = nn.ModuleList([Downsample2D(cout)])
        elif resample is Upsample2D:
            self.upsamplers = nn.ModuleList([Upsample2D(cout)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for m in getattr(self, "downsamplers", ()):
            x = m(x)
        for m in getattr(self, "upsamplers", ()):
            x = m(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chs, groups, last = cfg["block_out_channels"], cfg["norm_num_groups"], len(cfg["block_out_channels"]) - 1
        self.conv_in = nn.Conv2d(cfg["in_channels"], chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            Block(chs[max(i - 1, 0)], chs[i], cfg["layers_per_block"], groups, None if i == last else Downsample2D)
            for i in range(len(chs)))
        self.mid_block = MidBlock(chs[-1], groups, cfg["mid_block_add_attention"])
        self.conv_norm_out = nn.GroupNorm(groups, chs[-1], eps=EPS)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(_silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        chs, groups = tuple(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
        self.conv_in = nn.Conv2d(cfg["latent_channels"], chs[0], 3, padding=1)
        self.mid_block = MidBlock(chs[0], groups, cfg["mid_block_add_attention"])
        self.up_blocks = nn.ModuleList(
            Block(chs[max(k - 1, 0)], chs[k], cfg["layers_per_block"] + 1, groups,
                  None if k == len(chs) - 1 else Upsample2D)
            for k in range(len(chs)))
        self.conv_norm_out = nn.GroupNorm(groups, chs[-1], eps=EPS)
        self.conv_out = nn.Conv2d(chs[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(_silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """NCHW in and out, fp32."""

    def __init__(self, **overrides):
        super().__init__()
        cfg = {**CONFIG, **overrides}
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode(self, x):
        """(mean, logvar) of the posterior, each (b, latent, h/8, w/8)."""
        mean, logvar = torch.chunk(self.encoder(x), 2, dim=1)
        return mean, torch.clamp(logvar, *LOGVAR_RANGE)

    def decode(self, z):
        return self.decoder(z)

    def reconstruct(self, x):
        """The decode of the posterior's mean (its mode)."""
        return self.decode(self.encode(x)[0])

    def forward(self, x, noise):
        """The decode of the posterior sample mean + exp(½ logvar)·noise."""
        mean, logvar = self.encode(x)
        return self.decode(mean + torch.exp(0.5 * logvar) * noise)
