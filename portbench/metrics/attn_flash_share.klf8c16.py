"""The share of the 1024² evaluation window's attention calls that took B1,
in %: the program's counter `attn.flash` over all its `attn.*` route counts
(`attn.flash`, `attn.fused`, `attn.plain`; one a call of
ops/attention.py:attention). None where the program counts no route."""

from portbench import program_spans


def read(run):
    counts = {r: program_spans.counter(f"attn.{r}") or 0 for r in ("flash", "fused", "plain")}
    total = sum(counts.values())
    return 100.0 * counts["flash"] / total if total else None
