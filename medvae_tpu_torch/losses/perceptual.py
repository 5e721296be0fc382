"""Frozen perceptual towers (counterpart of medvae_tpu/losses/perceptual.py:36-288).

  * `LPIPSNet` / `LPIPSLoss`: AlexNet conv trunk, five taps unit-normalized
    over channels (eps outside the sqrt), squared difference, |lin| 1×1
    heads, spatial mean, sum over taps; inputs rescaled to [−1, 1], gray
    repeated to RGB, and below 64 px bilinearly upsampled to 64 first.
  * `SimpleCLIPEncoder`, and `BiomedCLIPLoss` on it or on `CLIPViT`:
    clamp((x + 1)/2, 0, 1), gray→RGB, a cubic resize to 224 when the size
    differs, CLIP normalization, then the squared feature distance summed over
    features and averaged over the batch.

A loss object holds the configuration; the tower itself is an nn.Module that
the train state keeps in `frozen` (the JAX package's frozen param trees), made
by `init(seed)` with requires_grad off. The gradient still flows through the
tower into the reconstruction. Module and parameter names are the JAX
package's (`alex.conv1`, `lin0`, `Conv_0`, `Dense_1`, …). NHWC in.

A loss's `dtype` is the towers' compute dtype (`loss.tower_dtype`,
medvae_tpu/train/step.py:147-158): fp32 by default, whatever the dtype of the
images; with bf16 the convolutions and dense layers take bf16 operands (the
params stay fp32, as under Flax's `dtype`, and each frozen layer keeps one
bf16 copy of them: losses/clip_vit.py:_weights), while the
LPIPS scaling constants follow the tower dtype, and the channel
unit-normalize, the lin heads and the feature distances reduce in fp32 (the
ViT's LayerNorms and attention logits: losses/clip_vit.py).

The resizes are core/resize.py's, built by hand as jax.image.resize builds
them: F.interpolate's bicubic uses a = −0.75 and gives other numbers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from medvae_tpu_torch.core.precision import configure_backends
from medvae_tpu_torch.core.resize import resize
from medvae_tpu_torch.losses.clip_vit import CLIPViT, conv, dense

_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _to_rgb(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) → (B, H, W, 3) by channel repeat."""
    return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


@torch.no_grad()
def init_tower(module: nn.Module, seed: int) -> nn.Module:
    """Random frozen weights from a seeded CPU generator, with the JAX
    initializers' scales: conv and dense kernels ~ N(0, 1/fan_in), biases 0,
    LayerNorm 1 and 0, the tower's own params by its `init_own`. The tower
    will compute in exact fp32 (`configure_backends`)."""
    configure_backends()
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    if hasattr(module, "init_own"):
        module.init_own(gen)
    return module.eval().requires_grad_(False)




_constants: dict = {}  # (values, device, dtype) -> the tensor there


def _constant(values: tuple, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A tower's normalization constants on `like`'s device, made once for a
    plain tensor (a step that a CUDA graph captures copies nothing from the
    host); a tracer's tensor gets its own. Made outside inference mode, so
    that a constant first made under `torch.inference_mode()` can still be
    saved for a backward (core/resize.py's matrices alike)."""
    key = (values, like.device, dtype)
    if type(like) is torch.Tensor and key in _constants:
        return _constants[key]
    with torch.inference_mode(False):
        out = torch.tensor(values, dtype=dtype, device=like.device)
    if type(like) is torch.Tensor and type(out) is torch.Tensor:
        _constants[key] = out
    return out

class AlexNetFeatures(nn.Module):
    """AlexNet conv trunk emitting the five LPIPS taps (relu1..relu5); NCHW."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32):
        t1 = F.relu(conv(self.conv1, x, dtype))
        t2 = F.relu(conv(self.conv2, F.max_pool2d(t1, 3, 2), dtype))
        t3 = F.relu(conv(self.conv3, F.max_pool2d(t2, 3, 2), dtype))
        t4 = F.relu(conv(self.conv4, t3, dtype))
        t5 = F.relu(conv(self.conv5, t4, dtype))
        return t1, t2, t3, t4, t5


class LPIPSNet(nn.Module):
    """Scaling layer → trunk taps → unit-normalize → squared diff → |lin|
    heads → spatial mean → sum over taps; (B,) out."""

    channels = (64, 192, 384, 256, 256)

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, c in enumerate(self.channels):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((c,), 1.0 / c)))

    @torch.no_grad()
    def init_own(self, gen: torch.Generator) -> None:
        for i, c in enumerate(self.channels):  # the JAX init: constant 1/C
            getattr(self, f"lin{i}").fill_(1.0 / c)

    @staticmethod
    def _unit_normalize(x: torch.Tensor) -> torch.Tensor:
        x = x.float()  # the channel sum of squares in fp32 whatever the taps' dtype
        return x / (torch.sqrt(x.square().sum(dim=1, keepdim=True)) + 1e-10)

    def forward(self, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        shift = _constant(_LPIPS_SHIFT, a, dtype)
        scale = _constant(_LPIPS_SCALE, a, dtype)
        fa = self.alex(_nchw((a - shift) / scale), dtype)
        fb = self.alex(_nchw((b - shift) / scale), dtype)
        total = torch.zeros((a.shape[0],), dtype=torch.float32, device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            diff = (self._unit_normalize(xa) - self._unit_normalize(xb)).square()
            d = torch.einsum("bchw,c->bhw", diff, getattr(self, f"lin{i}").abs())
            total = total + d.mean(dim=(1, 2))
        return total


class LPIPSLoss:
    """Batch-mean LPIPS between inputs and reconstructions in model space;
    `dtype` the trunk's compute dtype."""

    MIN_SIZE = 64  # AlexNet's stride/pool chain needs 64 px

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def init(self, seed: int, device="cpu") -> LPIPSNet:
        return init_tower(LPIPSNet().to(device), seed)

    def __call__(self, net: LPIPSNet, inputs: torch.Tensor, recons: torch.Tensor) -> torch.Tensor:
        a = _to_rgb(inputs) * 2.0 - 1.0
        b = _to_rgb(recons) * 2.0 - 1.0
        if a.shape[1] < self.MIN_SIZE or a.shape[2] < self.MIN_SIZE:
            a = resize(a, self.MIN_SIZE, "linear")
            b = resize(b, self.MIN_SIZE, "linear")
        return net(a, b, self.dtype).mean()


class SimpleCLIPEncoder(nn.Module):
    """The reference's CLIP-fallback CNN: 7×7/2 conv → pool → 3×3/2 conv →
    pool → 3×3/2 conv → global mean → MLP(512); NHWC in."""

    def __init__(self, embed_dim: int = 512):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.Conv_1 = nn.Conv2d(64, 128, 3, stride=2, padding=1)
        self.Conv_2 = nn.Conv2d(128, 256, 3, stride=2, padding=1)
        self.Dense_0 = nn.Linear(256, embed_dim)
        self.Dense_1 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        h = F.max_pool2d(F.relu(conv(self.Conv_0, _nchw(x), dtype)), 2, 2)
        h = F.max_pool2d(F.relu(conv(self.Conv_1, h, dtype)), 2, 2)
        h = F.relu(conv(self.Conv_2, h, dtype)).mean(dim=(2, 3))
        return dense(self.Dense_1, F.relu(dense(self.Dense_0, h, dtype)), dtype)


class BiomedCLIPLoss:
    """Squared feature distance between the embeddings of the input and of the
    reconstruction (`compute_rec_loss`), plus with `compute_lat_loss` the
    distance to the embedding of the latent: latent / 4.6 pooled over its
    channels, resized linearly to 224², tiled to 3 channels and fed to the
    tower without the CLIP normalization (medvae_tpu/losses/perceptual.py:
    210-288). `dtype` is the tower's compute dtype."""

    def __init__(self, encoder: str = "simple", compute_rec_loss: bool = True,
                 compute_lat_loss: bool = False, dtype: torch.dtype = torch.float32):
        if encoder not in ("vit", "simple"):
            raise ValueError(f"Unknown clip encoder: {encoder}")
        self.encoder = encoder
        self.compute_rec_loss, self.compute_lat_loss = compute_rec_loss, compute_lat_loss
        self.dtype = dtype

    def init(self, seed: int, device="cpu") -> nn.Module:
        cls = CLIPViT if self.encoder == "vit" else SimpleCLIPEncoder
        return init_tower(cls().to(device), seed)

    @staticmethod
    def _preprocess(img: torch.Tensor) -> torch.Tensor:
        img = _to_rgb(torch.clamp((img + 1.0) / 2.0, 0.0, 1.0))
        if img.shape[1:3] != (224, 224):
            img = resize(img, 224, "cubic")
        mean = _constant(_CLIP_MEAN, img, img.dtype)
        std = _constant(_CLIP_STD, img, img.dtype)
        return (img - mean) / std

    def __call__(self, net: nn.Module, img: torch.Tensor, rec: Optional[torch.Tensor] = None,
                 latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        img_features = net(self._preprocess(img), self.dtype).float()
        total = torch.zeros((), dtype=torch.float32, device=img.device)
        if self.compute_rec_loss and rec is not None:
            rec_features = net(self._preprocess(rec), self.dtype).float()
            total = total + (img_features - rec_features).square().sum(dim=1).mean()
        if self.compute_lat_loss and latent is not None:
            lat = (latent / 4.6).mean(dim=-1, keepdim=True)  # pooled over channels (NHWC)
            lat = resize(lat, 224, "linear").repeat(1, 1, 1, 3)
            lat_features = net(lat, self.dtype).float()
            total = total + (img_features - lat_features).square().sum(dim=1).mean()
        return total
