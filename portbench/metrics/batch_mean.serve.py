"""Requests per `InferenceEngine.reconstruct` call in the window, counted by
the benchmark's wrapper on the engine instance (the batcher's batch size)."""


def read(run):
    calls = run.record.counters.get("calls") or []
    if not calls:
        return None
    return sum(n for n, _ in calls) / len(calls)
