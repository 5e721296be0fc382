"""Device ms per train step in the "elementwise / copy / other" category of
the copied chip_smoke categories (portbench/trace.py)."""

from portbench.trace import OTHER, category


def read(run):
    steps = run.work.get("steps", 0)
    if run.trace is None or not steps:
        return None
    ns = sum(e - s for name, s, e in run.trace.kernels() if category(name) == OTHER)
    return ns / 1e6 / steps if ns else None
