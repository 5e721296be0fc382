"""Supervise a training run of the port: relaunch on crash, resuming from
`last` (counterpart of scripts/train_resilient.py:39-132).

    python -m medvae_tpu_torch.cli.train_resilient [supervisor flags] -- <train CLI args>

    python -m medvae_tpu_torch.cli.train_resilient --max-restarts 50 -- \\
        experiment=disentangled_multi_modal_cvae_full \\
        +checkpointing.every_n_steps=50 training.max_epochs=100

Runs `python -m medvae_tpu_torch.cli.train` with the given arguments; when it
exits non-zero, waits (exponential backoff from --backoff, capped at
--max-backoff), appends `+resume=true` once, and relaunches. The port's
resume continues bit for bit at the optimizer step of `last`
(train/trainer.py), so a crashed run loses only the steps since `last`
(`checkpointing.every_n_steps` refreshes it within an epoch).

Crash-loop guard: --max-fast-failures relaunches in a row that die sooner
than --min-uptime are taken for a deterministic failure (a bad config, out
of memory every step), and the supervisor gives up with the run's exit
code; a run that stays up longer resets the count. --max-restarts bounds the
relaunches. `supervise(..., runner=, sleeper=, clock=)` takes its launcher,
sleep and clock as arguments, for tests.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def train_command(argv: list) -> list:
    """The train CLI's command line for `argv`."""
    return [sys.executable, "-m", "medvae_tpu_torch.cli.train", *argv]


def supervise(
    train_args: list,
    *,
    max_restarts: int = 20,
    backoff_s: float = 30.0,
    max_backoff_s: float = 600.0,
    min_uptime_s: float = 120.0,
    max_fast_failures: int = 2,
    runner=None,
    sleeper=time.sleep,
    clock=time.monotonic,
) -> int:
    """Run the train CLI under supervision; return its final exit code.
    `runner(argv) -> exit code` defaults to a subprocess of
    `train_command(argv)`."""
    if runner is None:
        def runner(argv: list) -> int:
            return subprocess.call(train_command(argv))

    argv = list(train_args)
    resumed = any(a.split("=", 1)[0].lstrip("+") == "resume" for a in argv)
    fast_failures = 0
    delay = backoff_s
    code = 0
    for attempt in range(max_restarts + 1):
        t0 = clock()
        code = runner(argv)
        uptime = clock() - t0
        if code == 0:
            if attempt:
                print(f"[resilient] completed after {attempt} restart(s)")
            return 0
        fast_failures = fast_failures + 1 if uptime < min_uptime_s else 0
        if fast_failures >= max_fast_failures:
            print(f"[resilient] {fast_failures} consecutive failures in <{min_uptime_s:.0f}s "
                  f"(exit {code}) — deterministic failure, giving up", file=sys.stderr)
            return code
        if attempt == max_restarts:
            print(f"[resilient] exit {code}; restart budget ({max_restarts}) spent", file=sys.stderr)
            return code
        if not resumed:
            argv = [*argv, "+resume=true"]
            resumed = True
        print(f"[resilient] exit {code} after {uptime:.0f}s; restart {attempt + 1}/{max_restarts} "
              f"in {delay:.0f}s (+resume=true)", file=sys.stderr)
        sleeper(delay)
        delay = min(delay * 2, max_backoff_s)
    return code


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                usage="%(prog)s [flags] -- <train CLI args>")
    p.add_argument("--max-restarts", type=int, default=20)
    p.add_argument("--backoff", type=float, default=30.0, metavar="SECONDS")
    p.add_argument("--max-backoff", type=float, default=600.0, metavar="SECONDS")
    p.add_argument("--min-uptime", type=float, default=120.0, metavar="SECONDS",
                   help="exits faster than this count as fast failures")
    p.add_argument("--max-fast-failures", type=int, default=2,
                   help="consecutive fast failures that end the supervision")
    if "--" not in argv:
        p.error("separate the train CLI's arguments with `--`")
    split = argv.index("--")
    ns = p.parse_args(argv[:split])
    return supervise(argv[split + 1:], max_restarts=ns.max_restarts, backoff_s=ns.backoff,
                     max_backoff_s=ns.max_backoff, min_uptime_s=ns.min_uptime,
                     max_fast_failures=ns.max_fast_failures)


if __name__ == "__main__":
    raise SystemExit(main())
