"""Multirun sweep expansion (the port's copy of medvae_tpu/config/sweep.py:31-153).

Hydra's basic-sweeper grammar, standalone, as `cli/train.py -m` expands it:

  * ``key=a,b,c``            — choice sweep (top-level commas only; commas
                               inside ``[] {} ()`` or quotes are values, so
                               ``model.ch_mult=[1,2,4]`` is one list, and a
                               ``\\,`` escape yields a literal comma)
  * ``key=choice(a,b,c)``    — explicit choice sweep
  * ``key=range(s,e[,step])``— numeric sweep, end-exclusive like Python/Hydra
  * anything else            — fixed for every job

Jobs iterate the *last* swept key fastest (itertools.product over keys in
CLI order), as Hydra's do. The port keeps its own copy: it imports nothing of
the JAX package, and tests/test_torch_port_sweep.py holds the two equal.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Iterable, List, Sequence, Tuple

_CHOICE_RE = re.compile(r"^choice\((.*)\)$", re.S)
_RANGE_RE = re.compile(r"^range\((.*)\)$", re.S)


def _split_top_level(raw: str) -> List[str]:
    """Split on commas not nested in brackets/quotes; ``\\,`` escapes."""
    parts: List[str] = []
    buf: List[str] = []
    depth = 0
    quote = ""
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == "\\" and i + 1 < len(raw) and raw[i + 1] == ",":
            buf.append(",")
            i += 2
            continue
        if quote:
            if ch == quote:
                quote = ""
            buf.append(ch)
        elif ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch in "([{":
            depth += 1
            buf.append(ch)
        elif ch in ")]}":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        i += 1
    parts.append("".join(buf))
    return parts


def _number(tok: str) -> Any:
    tok = tok.strip()
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def sweep_values(raw: str) -> List[str]:
    """Expand one override *value* into its sweep choices (len 1 = fixed).

    Returns raw value strings — the composer's normal YAML-scalar parsing
    applies per job, so each choice behaves exactly as if typed alone.
    """
    raw = raw.strip()
    m = _CHOICE_RE.match(raw)
    if m:
        return [p.strip() for p in _split_top_level(m.group(1))]
    m = _RANGE_RE.match(raw)
    if m:
        args = [_number(p) for p in _split_top_level(m.group(1))]
        if not 1 <= len(args) <= 3:
            raise ValueError(f"range() takes 1-3 numeric args: {raw!r}")
        start, stop = (0, args[0]) if len(args) == 1 else (args[0], args[1])
        step = args[2] if len(args) == 3 else 1
        if step == 0:
            raise ValueError(f"range() step must be nonzero: {raw!r}")
        out, i = [], 0
        while True:
            v = start + i * step  # no accumulation → no float drift
            if not ((v < stop) if step > 0 else (v > stop)):
                break
            out.append(repr(round(v, 12) if isinstance(v, float) else v))
            i += 1
        return out
    parts = _split_top_level(raw)
    # single value: keep the escape-processed form (\, -> ,) untouched otherwise
    return [p.strip() for p in parts] if len(parts) > 1 else [parts[0]]


def expand_multirun(
    overrides: Iterable[str],
) -> Tuple[List[List[str]], List[str]]:
    """Expand CLI overrides into per-job override lists (cartesian product).

    Returns ``(jobs, swept_keys)`` where each job is a plain single-run
    override list. With no swept values this is one job — ``train -m`` on a
    fixed config degenerates to a single run, as in Hydra.
    """
    # entries: (key, choices) for sweepable overrides, (None, [verbatim]) for
    # tokens without '=' (passed through so the composer raises its usual error)
    keyed: List[Tuple[Any, List[str]]] = []
    swept: List[str] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if "=" not in ov:
            keyed.append((None, [ov]))
            continue
        key, raw = ov.split("=", 1)
        values = sweep_values(raw)
        keyed.append((key, values))
        if len(values) > 1:
            swept.append(key.lstrip("+"))

    jobs: List[List[str]] = []
    for combo in itertools.product(*(vals for _, vals in keyed)):
        jobs.append(
            [
                (val if key is None else f"{key}={val}")
                for (key, _), val in zip(keyed, combo)
            ]
        )
    return jobs, swept


def job_label(job: Sequence[str], swept_keys: Sequence[str]) -> str:
    """Compact ``k=v,k2=v2`` tag of a job's *swept* values (for dirs/logs)."""
    parts = []
    for ov in job:
        if "=" not in ov:
            continue
        key, val = ov.split("=", 1)
        if key.lstrip("+") in swept_keys:
            parts.append(f"{key.lstrip('+')}={val}")
    return ",".join(parts)
