"""Padded slots over bucket slots of the window's engine calls, in %: each
call of n requests runs at the smallest bucket covering n."""


def read(run):
    calls = run.record.counters.get("calls") or []
    slots = sum(s for _, s in calls)
    if not slots:
        return None
    return 100.0 * (slots - sum(n for n, _ in calls)) / slots
