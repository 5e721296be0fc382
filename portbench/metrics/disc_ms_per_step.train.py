"""Device ms of the program's `step.disc` section per train step of the window
(CUDA events on the stream): D on x and on the detached reconstruction, its
hinge loss and gradients."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.device_ms(run, "step.disc"), run.work.get("steps", 0))
