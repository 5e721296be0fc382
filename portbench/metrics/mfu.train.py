"""The whole train step's share of the card's bf16 dense peak: the
reference's FLOPs of one step at the cell's shapes (convolutions, matmuls,
attention; forward and backward; counted on the meta device, no
recomputation) times the steps of the traced window, over the window's
seconds times 989 TFLOP/s. Bounds every kernel's gain, whatever implements
the work."""

from portbench.common import PEAK_BF16_FLOPS


def read(run):
    steps = run.work.get("steps", 0)
    if not steps or not run.flops_per_unit or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_unit * steps / (run.window_s * PEAK_BF16_FLOPS)
