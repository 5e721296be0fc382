"""VAE Encoder / Decoder (counterpart of medvae_tpu/nn/encoder_decoder.py:65-271).

NCHW in and out. Modules are laid out as the reference torch codec is
(`down.{i}.block.{j}`, `down.{i}.attn.{j}`, `down.{i}.downsample`,
`mid.block_1/attn_1/block_2`, `up.{i}.…`, `conv_in/out`, `norm_out`), so a
state_dict key names the same tensor in both. An attention block follows every
res block whose resolution is in `attn_resolutions`. The encoder's
`in_channels` is the width of what it is given: 2·C for the concat
ConditionalVAE, whose flax conv infers it from the input. Every res block
takes `dropout`, drawing its masks from the `generator` passed to forward.
Every attention site, the mid block's included, takes `make_attn`'s block
for `attn_type` ("linear" when `use_linear_attn`). The encoder takes the
ConditionalVAE's conditioning as the JAX Encoder does
(medvae_tpu/nn/encoder_decoder.py:95-166): a `temb` for every down and mid
res block (built with `temb_channels`), or `film`, one (scale, shift) pair
a level applied after the level's blocks and before its downsample. The
decoder takes neither.

Remat (`set_remat(module, rung)`, medvae_tpu/nn/encoder_decoder.py:26-62 and
medvae_tpu/models/base_vae.py:23-30): False keeps every activation;
"block" (or True) rematerializes each ResnetBlock, "conv" each block but
keeps its convolutions' outputs, "full" the whole Encoder and Decoder with
"block" nested inside. It changes no parameter, so a built and initialised
model can move between rungs; dropout masks are taped so the recompute
drops what the forward dropped (nn/blocks.py:remat).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from portbench.reference.blocks import (
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    Upsample,
    make_attn,
    norm_swish,
    remat,
)

REMAT_RUNGS = (False, "block", "conv", "full")


def remat_rung(value) -> str | bool:
    """A config's `model.remat` as a rung: False, "block", "conv" or
    "full" (True means "block"); JAX's ValueError for anything else."""
    if value in (None, False, 0) or str(value).lower() in ("false", "0", "none", "off"):
        return False
    if value is True or str(value).lower() in ("true", "1", "block"):
        return "block"
    if str(value).lower() in ("conv", "full"):
        return str(value).lower()
    raise ValueError(f"remat={value!r}: expected False, True/'block', 'conv', or 'full'")


def set_remat(module: nn.Module, rung) -> nn.Module:
    """Put every Encoder, Decoder and ResnetBlock under `module` on `rung`
    (see the module docstring); returns `module`."""
    rung = remat_rung(rung)
    for m in module.modules():
        if isinstance(m, ResnetBlock):
            m.remat = "block" if rung == "full" else rung
        elif isinstance(m, (Encoder, Decoder)):
            m.remat_full = rung == "full"
    return module


def _mid(channels: int, dropout: float, attn_type: str, temb_channels: int = 0) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(channels, channels, dropout, temb_channels)
    mid.attn_1 = make_attn(channels, attn_type)
    mid.block_2 = ResnetBlock(channels, channels, dropout, temb_channels)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor, generator, temb=None) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h, generator, temb)), generator, temb)


class Encoder(nn.Module):
    remat_full = False  # the "full" rung: the whole forward rematerialized

    def __init__(
        self,
        *,
        ch: int,
        num_res_blocks: int,
        attn_resolutions: Sequence[int],
        in_channels: int,
        resolution: int,
        z_channels: int,
        ch_mult: Sequence[int] = (1, 2, 4, 8),
        double_z: bool = True,
        dropout: float = 0.0,
        use_linear_attn: bool = False,
        attn_type: str = "vanilla",
        temb_channels: int = 0,
    ):
        super().__init__()
        attn_type = "linear" if use_linear_attn else attn_type
        self.num_res_blocks = num_res_blocks
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        in_ch_mult = (1,) + tuple(ch_mult)
        curr_res = resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * mult
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, dropout, temb_channels))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(make_attn(block_in, attn_type))
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in, dropout, attn_type, temb_channels)
        self.norm_out = GroupNorm(block_in)
        out_channels = 2 * z_channels if double_z else z_channels
        self.conv_out = Conv2d(block_in, out_channels, 3, padding=1)

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None,
        temb: torch.Tensor | None = None,
        film: Sequence[Tuple[torch.Tensor, torch.Tensor]] | None = None,
    ) -> torch.Tensor:
        """`temb`: (b, temb_channels); `film`: a (scale, shift) pair of
        (b, C_level) a level."""
        if self.remat_full and self.training and torch.is_grad_enabled():
            return remat(self._forward, x, generator, temb, film)
        return self._forward(x, generator, temb, film)

    def _forward(self, x, generator, temb, film) -> torch.Tensor:
        h = self.conv_in(x)
        for i_level, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(h, generator, temb)
                if len(level.attn):
                    h = level.attn[j](h)
            if film is not None:
                scale, shift = film[i_level]
                h = h * scale[:, :, None, None].to(h.dtype) + shift[:, :, None, None].to(h.dtype)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h, generator, temb)
        return self.conv_out(norm_swish(self.norm_out, h))


class Decoder(nn.Module):
    """The latent -> image decoder. `give_pre_end` returns the activation
    before norm_out; `tanh_out` ends in tanh
    (medvae_tpu/nn/encoder_decoder.py:186-187,264-270)."""

    remat_full = False  # the "full" rung: the whole forward rematerialized

    def __init__(
        self,
        *,
        ch: int,
        out_ch: int,
        num_res_blocks: int,
        attn_resolutions: Sequence[int],
        resolution: int,
        z_channels: int,
        ch_mult: Sequence[int] = (1, 2, 4, 8),
        dropout: float = 0.0,
        use_linear_attn: bool = False,
        attn_type: str = "vanilla",
        give_pre_end: bool = False,
        tanh_out: bool = False,
    ):
        super().__init__()
        attn_type = "linear" if use_linear_attn else attn_type
        self.give_pre_end, self.tanh_out = give_pre_end, tanh_out
        num_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_levels - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _mid(block_in, dropout, attn_type)
        levels = {}
        for i_level in reversed(range(num_levels)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(make_attn(block_in, attn_type))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            levels[i_level] = level
        # indexed by level, as the reference's `up` list is
        self.up = nn.ModuleList(levels[i] for i in range(num_levels))
        if not give_pre_end:  # flax builds no norm_out / conv_out then
            self.norm_out = GroupNorm(block_in)
            self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.remat_full and self.training and torch.is_grad_enabled():
            return remat(self._forward, z, generator)
        return self._forward(z, generator)

    def _forward(self, z: torch.Tensor, generator) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z), generator)
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(h, generator)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.give_pre_end:
            return h
        h = self.conv_out(norm_swish(self.norm_out, h))
        return torch.tanh(h) if self.tanh_out else h
