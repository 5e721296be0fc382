"""B1, the flash-attention forward (medvae_tpu_torch/ops/csrc/flash_fwd.cu),
one kernel a call. The arithmetic is chip_smoke.py's (phase_kernel's
bound), frozen here: 4·b·n²·c operations (the q kᵀ and
P v products) on the bf16 tensor cores; q, k, v read once, o written once
in bf16 (the fp32 row log-sum-exp of the training forward, 4·b·n bytes,
is left out, as chip_smoke left it out of B1's bound)."""

from portbench.common import PEAK_BF16_FLOPS

FRAGMENTS = ("flash_fwd",)
KERNELS_PER_CALL = 1
ELEMENT_BYTES = 2  # bf16


def work(shape):
    b, n, c = shape
    flops = 4.0 * b * n * n * c
    nbytes = 4.0 * b * n * c * ELEMENT_BYTES
    return flops, nbytes, PEAK_BF16_FLOPS
