"""The share of the training window's optimizer updates that took the fused
AdamW kernels, in %: the program's counters `optim.fused` / (`optim.fused` +
`optim.plain`), one a call of `Optimizer.apply_` by its route
(medvae_tpu_torch/train/optim.py). None where the program counted neither."""

from portbench import program_spans


def read(run):
    fused, plain = program_spans.counter("optim.fused") or 0, program_spans.counter("optim.plain") or 0
    return 100.0 * fused / (fused + plain) if fused + plain else None
