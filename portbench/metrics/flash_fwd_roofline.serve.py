"""B1 (`flash_fwd`) at its calls in the serving window: the bound ms of each
call (portbench/roofline/flash_fwd.py) summed, over the trace's device ms
of its kernels, in %."""

from portbench.roofline import flash_fwd
from portbench.trace import roofline_share


def read(run):
    return roofline_share(run.trace, flash_fwd.FRAGMENTS, flash_fwd.KERNELS_PER_CALL,
                          run.kernel_calls.get("flash_fwd", []), flash_fwd.work)
