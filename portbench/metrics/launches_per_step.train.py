"""CUDA kernel events in the traced window (copies and fills left out) per
train step."""


def read(run):
    steps = run.work.get("steps", 0)
    if run.trace is None or not steps:
        return None
    kernels = run.trace.kernels()
    return len(kernels) / steps if kernels else None
