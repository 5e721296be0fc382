"""The program's `alloc.retries` counter per train step of the traced
window: the caching allocator's retries (`num_alloc_retries`), each of which
frees the cache and synchronizes the card."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.counter("alloc.retries"), run.work.get("steps", 0))
