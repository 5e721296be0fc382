"""The 1024² evaluation's share of the card's bf16 dense peak: the reference's
FLOPs of one image's forward (encode, decode; counted on the meta device)
times the valid images of the window, over the window's seconds times 989
TFLOP/s, in %."""

from portbench.common import PEAK_BF16_FLOPS


def read(run):
    images = run.work.get("images", 0)
    if not images or not run.flops_per_unit or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_unit * images / (run.window_s * PEAK_BF16_FLOPS)
