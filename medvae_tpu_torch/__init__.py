"""PyTorch/CUDA port of medvae_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports torch and nothing
of JAX or medvae_tpu. Public model functions keep the JAX package's NHWC
layout; modules run NCHW inside.
"""
