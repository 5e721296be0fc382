"""Host ms in the program's `feed.gather` spans per evaluation batch of the
window: the host's gather of the next batch (native.assemble_batch)."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.host_ms(run, "feed.gather"), run.work.get("batches", 0))
