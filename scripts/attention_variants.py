"""Time variants of kernels B4 and B5 (medvae_tpu_torch/ops/csrc/attention.cu)
side by side on one card, at the 128² BaseVAE's (64, 256, 1024) bf16 shape.

    python scripts/attention_variants.py

Each variant is the committed source with a few literal substitutions
(VARIANTS below), built by nvcc with the port's flags (which hold -Xptxas -v) into
build/attention_variants/, loaded with ctypes and timed with CUDA events
(median of 20 launches a round, rounds in turn so that clocks drift alike).
Beside them, from the committed build, the FMA instance at the same shape
(`medvae_attention_{fwd,bwd}_bf16_fma`). Prints one JSON line a variant: the
registers and spills ptxas reports for the Hopper instance's kernels, B4 and
B5 ms, and the largest difference of its outputs from the committed build's
(variants that skip work are for timing only). Needs the card and nvcc; it
imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import _variants  # puts the repo's root on sys.path

KERNELS = ("attention_rows_wgmma_kernelILb1E", "attention_rows_wgmma_kernelILb0E",
           "attention_cols_wgmma_kernelILi2E")
# committed: the rows and columns passes on persistent grids (one block an
# SM), a three-stage ring, 256-column tiles in pass (b) where c allows
WAIT_STAGE = "    wgmma_commit();\n    wgmma_wait_all();\n    mbar_arrive(ring.empty(s));\n  }\n"
WAIT_ONE = '    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");\n'
VARIANTS = {
    "committed": [],
    # B5's pass (a) alone, without pass (b) (wrong output; timing only)
    "bwd_rows_pass_only": [("  if (err != 0) return err;\n  return c % 256 == 0",
                            "  if (err != 0 || c > 0) return err;\n  return c % 256 == 0")],
    # pass (b) with 128-column tiles (one box a consumer) at every c
    "cols_128_wide": [("return c % 256 == 0 ? launch_cols<2>", "return false ? launch_cols<2>")],
    # one block a tile in both passes instead of persistent grids
    "block_a_tile": [("  err = grid_blocks((long long)b * ((n + kHRows - 1) / kHRows), &blocks);",
                      "  blocks = (int)((long long)b * ((n + kHRows - 1) / kHRows));"),
                     ("  err = grid_blocks(tiles, &blocks);", "  blocks = (int)tiles;")],
    # one wgmma group kept in flight across stages in both passes' main loops
    # (a stage is freed once the group after it is issued)
    "in_flight": [(WAIT_STAGE,
                   "    wgmma_commit();\n" + WAIT_ONE +
                   "    if (ch > 0) mbar_arrive(ring.empty((*it + kHStages - 1) % kHStages));\n  }\n"
                   "  wgmma_wait_all();\n  mbar_arrive(ring.empty((*it + kHStages - 1) % kHStages));\n")],
    # rings of two and four stages instead of three
    "stages_2": [("constexpr int kHStages = 3;", "constexpr int kHStages = 2;")],
    "stages_4": [("constexpr int kHStages = 3;", "constexpr int kHStages = 4;")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    built = _variants.build_variants("attention.cu", VARIANTS, KERNELS)
    b, n, c = 64, 256, 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((b, n, c), generator=gen, device="cuda").bfloat16() for _ in range(4))
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty((6 * b * n * 256 * 2,), dtype=torch.uint8, device="cuda")
    committed = built["committed"][0]
    calls = {name: (_variants.bind(lib, "medvae_attention_fwd_bf16", 4),
                    _variants.bind(lib, "medvae_attention_bwd_bf16", 8)) for name, (lib, _, _) in built.items()}
    calls["fma_instance"] = (_variants.bind(committed, "medvae_attention_fwd_bf16_fma", 4),
                             _variants.bind(committed, "medvae_attention_bwd_bf16_fma", 8))
    outs = {name: [torch.empty_like(q) for _ in range(4)] for name in calls}

    def launch(key):
        name, which = key
        o, dq, dk, dv = outs[name]
        fwd, bwd = calls[name]
        args = ((q, k, v, o) if which == "fwd" else (q, k, v, g, dq, dk, dv, scratch))
        _variants.check((fwd if which == "fwd" else bwd)(*(t.data_ptr() for t in args), b, n, c, c ** -0.5, stream),
                        f"variant {name} {which}")

    times = _variants.time_rounds([(name, which) for name in calls for which in ("fwd", "bwd")], launch, calls=20)
    smi = _variants.gpu()
    ref = [t.float() for t in outs["committed"]]
    for name in calls:
        _, stats, serialized = built.get(name, (None, None, None))
        print(json.dumps({
            "variant": name, "shape": [b, n, c], "gpu": smi, "ptxas": stats,
            "wgmma_serialized_warning": serialized,
            "fwd_ms": times[(name, "fwd")], "bwd_ms": times[(name, "bwd")],
            "max_abs_diff_from_committed": [(o.float() - r).abs().max().item()
                                            for o, r in zip(outs[name], ref)],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
