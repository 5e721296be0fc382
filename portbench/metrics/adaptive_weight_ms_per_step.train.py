"""Device ms of the program's `step.adaptive_weight` section per train step of
the window (CUDA events on the stream): rec_for_adaptive, the two gradients
on the decoder's conv_out, the adaptive weight."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.device_ms(run, "step.adaptive_weight"), run.work.get("steps", 0))
