"""Host ms in the program's `engine.launch` spans (the model's encode and
decode issued to the card) per engine call of the window; near the device ms
when the host launches no faster than the card runs, or blocks on a full
launch queue."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.host_ms(run, "engine.launch"), run.work.get("engine_calls", 0))
