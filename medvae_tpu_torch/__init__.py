"""PyTorch/CUDA port of medvae_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and nothing
of JAX or medvae_tpu. Public model functions keep the JAX package's NHWC
layout; modules run NCHW inside.
"""

__version__ = "0.1.0"

from medvae_tpu_torch import config  # noqa: E402,F401
