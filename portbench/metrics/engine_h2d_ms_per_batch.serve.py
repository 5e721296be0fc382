"""Host ms in the program's `engine.h2d` spans (each chunk padded and copied
to the card from pageable memory) per engine call of the window."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.host_ms(run, "engine.h2d"), run.work.get("engine_calls", 0))
