"""B1 (`flash_fwd`) at the 1024² autoencoder's mid-block attentions in the
evaluation window: the bound ms of each call (portbench/roofline/flash_fwd.py),
the calls being the configuration's `kernel_sites` at the batch size for
every batch of the window (the benchmark's own count, not the program's),
summed, over the trace's device ms of its kernels, in %."""

from portbench.roofline import flash_fwd
from portbench.trace import roofline_share


def read(run):
    cfg = run.cell["model"]
    bs, batches = int(cfg["data"]["batch_size"]), int(run.work.get("batches", 0))
    calls = [(bs, *site) for _ in range(batches) for site in cfg["kernel_sites"].get("flash_fwd", [])]
    return roofline_share(run.trace, flash_fwd.FRAGMENTS, flash_fwd.KERNELS_PER_CALL, calls, flash_fwd.work)
