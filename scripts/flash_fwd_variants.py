"""Time variants of kernel B1 (medvae_tpu_torch/ops/csrc/flash_fwd.cu) side
by side on one card, at the flagship's (32, 3136, 512) bf16 shape.

    python scripts/flash_fwd_variants.py

Each variant is the committed source with a few literal substitutions
(VARIANTS below), built by nvcc with the port's flags (which hold -Xptxas -v) into
build/flash_fwd_variants/, loaded with ctypes and timed with CUDA events
(median of 20 launches a round, rounds in turn so that clocks drift alike).
Prints one JSON line a variant: its registers and spills as ptxas reports
them, ms without and with lse, and the largest difference of its output from
the committed build's (variants that skip work are for timing only).
Needs the card and nvcc; it imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import _variants  # puts the repo's root on sys.path

# the kernels that take c = 512: the Hopper instance's, and the mma.sync one's
# where a variant forces it
KERNELS = ("flash_fwd_wgmma_kernelILi512E", "flash_fwd_bf16_kernelILi64E")
TAKES_WGMMA = "bool takes_wgmma(int c) { return c % 128 == 0 && c <= 512; }"
MMA_SYNC = (TAKES_WGMMA, "bool takes_wgmma(int c) { return false; }")
VARIANTS = {
    "committed": [],
    # the mma.sync instance at the flagship shape, which it took before the wgmma one
    "mma_sync": [MMA_SYNC],
    # the same with K and V loaded once, not every step: what its synchronous
    # loads cost (wrong output; timing only)
    "mma_sync_kv_loaded_once": [MMA_SYNC, (
        "    load_tile(Ks, ld, k, kv0, TILE, n, c);\n    load_tile(Vs, ld, v, kv0, TILE, n, c);",
        "    if (kv0 == 0) {\n      load_tile(Ks, ld, k, kv0, TILE, n, c);\n"
        "      load_tile(Vs, ld, v, kv0, TILE, n, c);\n    }")],
    # the Hopper instance without the exchange of the partial logits: what
    # the split of Q K^T over two warpgroups costs (wrong output; timing only)
    "wgmma_no_exchange": [
        ('      asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n', ""),
        ("      for (int i = 0; i < 16; ++i) sc[i] += theirs[i * 128 + tid];\n", "")],
    # the Hopper instance with another register split between the roles
    "wgmma_regs_56_224": [
        ("setmaxnreg.dec.sync.aligned.u32 40;", "setmaxnreg.dec.sync.aligned.u32 56;"),
        ("setmaxnreg.inc.sync.aligned.u32 232;", "setmaxnreg.inc.sync.aligned.u32 224;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    built = _variants.build_variants("flash_fwd.cu", VARIANTS, KERNELS)
    b, n, c = 32, 3136, 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, n, c), generator=gen, device="cuda").bfloat16() for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    fns = {name: _variants.bind(lib, "medvae_flash_fwd_bf16", 5) for name, (lib, _, _) in built.items()}
    outs = {name: (torch.empty_like(q), torch.empty((b, n), device="cuda")) for name in built}

    def launch(key):
        name, with_lse = key
        o, lse = outs[name]
        _variants.check(fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr() if with_lse else None, b, n, c, c ** -0.5, stream),
                        f"variant {name}")

    times = _variants.time_rounds([(name, lse) for name in VARIANTS for lse in (False, True)], launch, calls=20)
    smi = _variants.gpu()
    ref = outs["committed"][0].float()
    for name, (_, stats, _) in built.items():
        ms = times[(name, False)]
        found = stats.get(KERNELS[1] if MMA_SYNC in VARIANTS[name] else KERNELS[0], {})
        print(json.dumps({
            "variant": name, "shape": [b, n, c], "gpu": smi, "registers": found.get("registers"),
            "spill_store_bytes": found.get("spill_store_bytes"), "ms": ms,
            "ms_with_lse": times[(name, True)], "tflops_per_s": 4.0 * b * n * n * c / ms / 1e9,
            "max_abs_diff_from_committed": (outs[name][0].float() - ref).abs().max().item(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
