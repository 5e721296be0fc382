"""B6 (`gn_swish_fwd`) in the 1024² evaluation window: the least bytes of its
launches (the program's counter `gn.fwd_bytes`, portbench/roofline/gn_swish.py's
arithmetic) over the peak bandwidth, over the trace's device ms of its
kernels, in %."""

from portbench.roofline import gn_swish


def read(run):
    return gn_swish.roofline(run, "gn.fwd_bytes", gn_swish.FWD_FRAGMENTS)
