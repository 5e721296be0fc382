"""B2 + B3, the flash-attention backward (medvae_tpu_torch/ops/csrc/
flash_bwd.cu): one call launches the Hopper instance's two passes
(`flash_planes_kernel`, `flash_grads_kernel`). The arithmetic is
chip_smoke.py's (`work["flash_bwd"]`), frozen here: five n×n×c products (S,
dP, dV, dK, dQ), 10·b·n²·c operations on the bf16 tensor cores; q, k, v,
dO in bf16 and the fp32 lse and delta read once, dq, dk, dv written once."""

from portbench.common import PEAK_BF16_FLOPS

FRAGMENTS = ("flash_planes_kernel", "flash_grads_kernel")
KERNELS_PER_CALL = 2
ELEMENT_BYTES = 2  # bf16


def work(shape):
    b, n, c = shape
    flops = 10.0 * b * n * n * c
    nbytes = 7.0 * b * n * c * ELEMENT_BYTES + 8.0 * b * n
    return flops, nbytes, PEAK_BF16_FLOPS
