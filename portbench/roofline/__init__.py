"""Kernel rooflines: each module names a kernel's trace-name fragments, its
kernels a call, and its operations, bytes and peak from a call's shape."""
