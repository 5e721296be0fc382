"""The benchmark's plain reference: a frozen copy of the port's plain model, loss,
optimizer and metric code, with plain attention and plain GroupNorm + SiLU, in
fp32 (TF32 off). It imports nothing of the port; the comparison that decides a
run's `correct` holds the port's outputs against it."""
