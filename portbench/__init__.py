"""The benchmark of the PyTorch/CUDA port (`medvae_tpu_torch`) on one H100; see run.py."""
