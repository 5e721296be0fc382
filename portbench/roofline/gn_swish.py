"""B6 and B7, the fused GroupNorm + SiLU forward and backward
(medvae_tpu_torch/ops/csrc/groupnorm_swish.cu), and the gate's route to
them. The byte arithmetic is chip_smoke.py's (phase_gn_kernel's `work`),
frozen here: each input read once and each output written once. B6 reads
x, γ and β and writes y and the (b, G) fp32 mean and rstd; B7 reads x, the
incoming gradient, γ, β, mean and rstd and writes dx, dγ and dβ. Bytes bound
both at bf16 and fp32: their 11 and 45 fp32 operations an element
(chip_smoke.py:GN_OPS_PER_ELEMENT) take under half the bytes' time at
67 TFLOP/s.

The program counts these bytes itself, a launch at a time, in its counters
`gn.fwd_bytes` and `gn.bwd_bytes` (ops/groupnorm_swish.py:min_bytes), and
each GroupNorm+SiLU site call by its route in `gn.fused` and `gn.plain`;
portbench/tests hold its arithmetic to this one."""

from portbench import program_spans
from portbench.common import PEAK_BYTES_PER_S

FWD_FRAGMENTS = ("gn_fwd_", "gn_row_stats", "gn_group_stats", "gn_swish_apply")  # every instance's B6
BWD_FRAGMENTS = ("gn_bwd",)  # gn_bwd_{resident,cluster,reduce,row,apply,params}
F32_BYTES = 4  # γ, β, the statistics, dγ, dβ


def fwd_bytes(shape, elem_bytes: int, groups: int) -> float:
    b, c, h, w = shape
    return 2.0 * b * c * h * w * elem_bytes + 2 * c * F32_BYTES + 2 * b * groups * F32_BYTES


def bwd_bytes(shape, elem_bytes: int, groups: int) -> float:
    b, c, h, w = shape
    return 3.0 * b * c * h * w * elem_bytes + 4 * c * F32_BYTES + 2 * b * groups * F32_BYTES


def roofline(run, counter: str, fragments) -> float:
    """100 × the bound seconds of the window's launches (the program's byte
    counter over the peak bandwidth) over the trace's device seconds of
    their kernels; None where either is missing."""
    nbytes = program_spans.counter(counter)
    if not nbytes or run.trace is None:
        return None
    events = run.trace.kernels(fragments)
    device_s = sum(e - s for _, s, e in events) / 1e9
    if device_s <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / device_s


def fused_share() -> float:
    """100 × the GroupNorm+SiLU site calls that took B6/B7 over all of them;
    None where the program counted none."""
    fused, plain = program_spans.counter("gn.fused") or 0, program_spans.counter("gn.plain") or 0
    return 100.0 * fused / (fused + plain) if fused + plain else None
