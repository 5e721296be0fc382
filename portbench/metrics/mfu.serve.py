"""The engine's share of the card's bf16 dense peak while it works: the
reference's FLOPs of one image's reconstruct (encode to the posterior mean,
decode; counted on the meta device) times the images served, over the host
seconds inside the engine's calls times 989 TFLOP/s, in %. Padding is not
counted as work."""

from portbench.common import PEAK_BF16_FLOPS


def read(run):
    busy = run.record.span_seconds("engine")
    images = run.work.get("images", 0)
    if not busy or not images or not run.flops_per_unit:
        return None
    return 100.0 * run.flops_per_unit * images / (busy * PEAK_BF16_FLOPS)
