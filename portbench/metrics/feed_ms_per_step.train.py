"""Host ms inside the feeder's next() per train step (the benchmark's
"feed" span around `DeviceFeeder`'s iterator), over the traced window."""


def read(run):
    steps = run.work.get("steps", 0)
    if not steps or not any(s[0] == "feed" for s in run.record.spans):
        return None
    return run.record.span_seconds("feed") * 1e3 / steps
