"""The 95th percentile of the program's `batcher.queue` spans over the
window's requests: each request's wait from `MicroBatcher.submit` until a
batch takes it, in ms."""

import numpy as np

from portbench import program_spans


def read(run):
    waits = [(s[3] - s[2]) / 1e6 for s in program_spans.spans(run, "batcher.queue")]
    return float(np.percentile(waits, 95)) if waits else None
