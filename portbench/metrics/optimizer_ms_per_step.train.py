"""Device ms of the program's `step.optimizer` section per train step of the
window (CUDA events on the stream): both optimizers' updates and the EMA."""

from portbench import program_spans


def read(run):
    return program_spans.per(program_spans.device_ms(run, "step.optimizer"), run.work.get("steps", 0))
