"""The share of the 1024² evaluation window's GroupNorm+SiLU site calls that
took B6/B7, in %: the program's counters `gn.fused` / (`gn.fused` +
`gn.plain`), one a call of the gate (ops/groupnorm_swish.py)."""

from portbench.roofline import gn_swish


def read(run):
    return gn_swish.fused_share()
