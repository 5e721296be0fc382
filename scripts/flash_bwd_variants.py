"""Time variants of the flash-attention backward's Hopper instance (kernels
B2 and B3, medvae_tpu_torch/ops/csrc/flash_bwd.cu) side by side on one card,
at the flagship's (32, 3136, 512) bf16 shape.

    python scripts/flash_bwd_variants.py

Each variant is the committed source with a few literal substitutions
(VARIANTS below), built by nvcc with the port's flags (which hold -Xptxas -v)
into build/flash_bwd_variants/, loaded with ctypes and timed with CUDA events
(median of 10 calls a round, three rounds in turn so that clocks drift
alike). Prints one JSON line a variant: the registers and spills
ptxas reports for the two passes' kernels, whether ptxas serialized a wgmma
(warning C7520), ms, TFLOP/s of the operations the variant does (10 b n^2 c
for the whole function), and the largest difference of its dq, dk, dv from
the committed build's (variants that skip work are for timing only). Needs
the card and nvcc; it imports no JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import _variants  # puts the repo's root on sys.path
from medvae_tpu_torch.ops import flash_attention as fa

KERNELS = ("flash_planes_kernel", "flash_grads_kernelILi256E")
PASS_B = "  if (c % 256 == 0) return launch_grads<256>"
VARIANTS = {
    "committed": [],
    # pass (a) alone: the planes, no products over them (timing only)
    "pass_a_only": [(PASS_B, "  return 0;\n" + PASS_B)],
    # pass (b) alone, over whatever the planes hold (timing only)
    "pass_b_only": [("  flash_planes_kernel<<<blocks", "  if (0) flash_planes_kernel<<<blocks")],
    # pass (a) without its TMA stores of the planes (timing only)
    "pass_a_no_stores": [(PASS_B, "  return 0;\n" + PASS_B),
                         ("if (tid == 0 && m0 < np) {", "if (tid == 0 && m0 < 0) {")],
    # P by expf, as torch.exp rounds, not by exp2f of a log2(e)-scaled argument
    "expf": [("exp2f((s[4 * j + e] * scale - row_lse[e >> 1]) * kLog2e)",
              "expf(s[4 * j + e] * scale - row_lse[e >> 1])")],
    # a ring of three stages in both passes
    "stages_3": [("constexpr int kBStages = 4;", "constexpr int kBStages = 3;")],
    # 128-column tiles in pass (b) at c = 512 too
    "pass_b_nw128": [(PASS_B, "  if (c % 256 == 7) return launch_grads<256>")],
}


# operations of the variants that do part of the work, in b n^2 c: pass (a)
# forms S and dP, pass (b) dQ, dK and dV
OPERATIONS = {"pass_a_only": 4, "pass_a_no_stores": 4, "pass_b_only": 6}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    built = _variants.build_variants("flash_bwd.cu", VARIANTS, KERNELS)
    b, n, c = 32, 3136, 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((b, n, c), generator=gen, device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * o.float()).sum(-1)
    planes = torch.empty(fa.plane_shape(b, n), dtype=q.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fns = {name: _variants.bind(lib, "medvae_flash_bwd_bf16", 10) for name, (lib, _, _) in built.items()}
    outs = {name: tuple(torch.empty_like(q) for _ in range(3)) for name in built}

    def launch(name):
        _variants.check(fns[name](*(t.data_ptr() for t in (q, k, v, g, lse, delta, *outs[name], planes)),
                                  b, n, c, c ** -0.5, stream), f"variant {name}")

    times = _variants.time_rounds(VARIANTS, launch, calls=10)
    smi = _variants.gpu()
    ref = outs["committed"]
    for name, ms in times.items():
        _, stats, serialized = built[name]
        print(json.dumps({
            "variant": name, "shape": [b, n, c], "gpu": smi, "ms": ms,
            "tflops_per_s": OPERATIONS.get(name, 10) * b * n * n * c / ms / 1e9,
            "ptxas": stats, "wgmma_serialized": serialized,
            "max_abs_diff_from_committed": max((x.float() - y.float()).abs().max().item()
                                               for x, y in zip(outs[name], ref)),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
