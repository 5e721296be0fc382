"""Device idle ms (the trace's idle gaps) in the hand-off from one batch's
device work to the next, per batch: host time inside a `batcher.batch` span
of the program (first dequeue to last result set) and outside its engine's
`engine.launch`, while the batcher collects and stacks requests, copies them
in and hands the results back. Pipelining the batcher shrinks it."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.idle_ms(run, "batcher.batch", "engine.launch"),
                             len(program_spans.spans(run, "batcher.batch")))
