"""Device ms of the program's `step.g_forward` section per train step of the
window (CUDA events on the stream): preprocess, the model's forward, D on
the reconstruction for G."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.device_ms(run, "step.g_forward"), run.work.get("steps", 0))
