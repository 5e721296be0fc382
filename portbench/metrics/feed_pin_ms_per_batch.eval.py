"""Host ms in the program's `feed.pin` spans per evaluation batch of the
window: pin_memory of each tensor and the queueing of the non-blocking copies."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.host_ms(run, "feed.pin"), run.work.get("batches", 0))
