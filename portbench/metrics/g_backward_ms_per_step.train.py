"""Device ms of the program's `step.g_backward` section per train step of the
window (CUDA events on the stream): the generator loss and G's gradients."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.device_ms(run, "step.g_backward"), run.work.get("steps", 0))
