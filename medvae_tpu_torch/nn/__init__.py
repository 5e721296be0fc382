"""The trunk's blocks, the encoder and decoder, and the PatchGAN. The
exported `GroupNormSwish` is the module (nn/blocks.py), not the autograd
Function of the same name in ops/groupnorm_swish.py."""

from medvae_tpu_torch.nn.blocks import (
    AttnBlock,
    Downsample,
    GroupNormSwish,
    LinAttnBlock,
    LinearAttention,
    ResnetBlock,
    Upsample,
    group_norm,
    make_attn,
    swish,
)
from medvae_tpu_torch.nn.discriminator import NLayerDiscriminator
from medvae_tpu_torch.nn.encoder_decoder import Decoder, Encoder

__all__ = [
    "AttnBlock",
    "Downsample",
    "GroupNormSwish",
    "LinAttnBlock",
    "LinearAttention",
    "ResnetBlock",
    "Upsample",
    "group_norm",
    "make_attn",
    "swish",
    "Encoder",
    "Decoder",
    "NLayerDiscriminator",
]
