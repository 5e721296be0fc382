"""Device ms per train step in convolutions and cuDNN's layout transforms
(the copied chip_smoke categories, portbench/trace.py)."""

from portbench.trace import category


def read(run):
    steps = run.work.get("steps", 0)
    if run.trace is None or not steps:
        return None
    ns = sum(e - s for name, s, e in run.trace.kernels()
             if category(name) in ("convolution", "cudnn layout transforms"))
    return ns / 1e6 / steps if ns else None
