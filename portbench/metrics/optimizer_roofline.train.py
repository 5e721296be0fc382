"""The optimizer section's share of its bandwidth roofline in the training
window, in %: the least bytes of the window's updates (the program's counter
`optim.least_bytes`: g, m, v and p read and m, v and p written once, and g
read once more for the clip's norm) over the peak bandwidth, over the device
ms of the program's `step.optimizer` sections (CUDA events; the EMA, where a
step has one, is inside). None where the program counted no bytes or timed
no section."""

from portbench import program_spans
from portbench.common import PEAK_BYTES_PER_S


def read(run):
    nbytes = program_spans.counter("optim.least_bytes")
    ms = program_spans.device_ms(run, "step.optimizer")
    if not nbytes or not ms:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / (ms / 1e3)
