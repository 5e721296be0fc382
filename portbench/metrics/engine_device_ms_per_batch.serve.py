"""Device ms of the program's `engine.launch` spans (CUDA events around the
model's encode and decode on the stream) per engine call of the window."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.device_ms(run, "engine.launch"), run.work.get("engine_calls", 0))
