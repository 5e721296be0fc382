"""Readings several per-layer metrics share."""


def idle_share(run):
    """100 × (1 − busy / window) of the traced window, where busy is the
    union of the device operations' intervals; None without a trace."""
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.events:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
