"""Host ms inside the feeder's next() per evaluation batch (the benchmark's
"feed" span around `DeviceFeeder`'s iterator)."""


def read(run):
    batches = run.work.get("batches", 0)
    if not batches or not any(s[0] == "feed" for s in run.record.spans):
        return None
    return run.record.span_seconds("feed") * 1e3 / batches
