"""The comparisons that decide a run's `correct`: each compared number with
its limit, from the cell's traffic file (`limits`), printed beside it.

Training (`train_gaps`): the first gradient's norm leaf by leaf, as the
optimizer got it (after clipping), over the leaves the cell names (the
encoder's, for the GAN); and the norm of each leaf's change over the first
steps, over every leaf and over the discriminator's. A leaf's gap is the gap
between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf; the median leaf's gap
is compared. Leaves whose reference gradient is under a thousandth of the
median leaf's (nought to rounding, moved by round-off alone under Adam) are
left out of the change.

The losses, the worst leaves and the decoder's gradient are printed and not
compared: on the H100 they swing from seed to seed by as much as the fp8
control moves them (PERF.md §6). AdamW's first updates are ±lr
wherever a gradient element is non-zero, so an element that bf16 rounds
across zero moves by 2·lr; the decoder's gradient carries the GAN's
adaptive weight, a ratio of two gradient norms of its last conv.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Tuple

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Each leaf's gap: |‖program‖ − ‖reference‖| over the larger of the
    reference's norm of that leaf and of the median leaf (inf where the
    program lacks the leaf)."""
    names = list(names)
    median = statistics.median(ref[n] for n in names)
    return {n: (abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) if n in prog else float("inf"))
            for n in names}


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    name = max(gaps, key=lambda n: (gaps[n] != gaps[n], gaps[n]))
    return gaps[name], name


def train_gaps(prog: Dict, ref: Dict, grad_leaves: str = "") -> Dict[str, object]:
    """The compared numbers of a training cell: the median leaf's gap of the
    first gradient over the leaves whose names start with `grad_leaves`
    (`grad_gap`), of the change over the steps over every moved leaf
    (`change_gap`) and over the discriminator's (`disc_change_gap`, GAN
    cells); the first step's losses, the worst leaves and the later steps'
    losses beside them, uncompared (see the module docstring)."""
    def loss_gap(p: Dict[str, float], r: Dict[str, float]) -> float:
        return max(abs(p.get(k, float("nan")) - v) / max(abs(v), 1e-12) for k, v in r.items())

    steps = len(prog["losses"]) == len(ref["losses"])
    step_gaps = [loss_gap(p, r) for p, r in zip(prog["losses"], ref["losses"])] if steps else [float("inf")]
    grads = _leaf_gaps(prog["grads"], ref["grads"], [n for n in ref["grads"] if n.startswith(grad_leaves)])
    median = statistics.median(ref["grads"].values())
    moved = [n for n, g in ref["grads"].items() if g >= NEGLIGIBLE_GRAD * median]
    changes = _leaf_gaps(prog["changes"], ref["changes"], moved)
    (gw, gn), (cw, cn) = _worst(grads), _worst(changes)
    out = {"grad_gap": statistics.median(grads.values()), "change_gap": statistics.median(changes.values()),
           "_loss_gap_by_step": step_gaps, "_grad_worst": [gw, gn], "_change_worst": [cw, cn],
           "_grad_leaves_compared": len(grads), "_leaves_moved": len(moved),
           "_leaves_left_out": len(ref["grads"]) - len(moved)}
    disc = [n for n in moved if n.startswith("disc.")]
    if disc:
        out["disc_change_gap"] = statistics.median(_leaf_gaps(prog["changes"], ref["changes"], disc).values())
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and every limit's number present and finite."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        if not (value == value and value <= limit):
            ok = False
    return ok, out


def print_checks(checks: Dict[str, Dict[str, float]], extra: Dict[str, object]) -> None:
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for k, v in extra.items():
        print(f"portbench check detail: {k} = {v}", file=sys.stderr)
    for name, c in checks.items():
        verdict = "ok" if c["value"] == c["value"] and c["value"] <= c["limit"] else "FAILS"
        print(f"portbench check: {name} = {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)


def max_rel_l2(pairs: List[Tuple[object, object]]) -> float:
    """The largest relative L2 gap ‖a − b‖ / ‖b‖ over (program, reference)
    pairs of tensors."""
    worst = 0.0
    for a, b in pairs:
        gap = float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))
        worst = gap if (gap > worst or gap != gap) else worst
    return worst
