"""Time variants of kernels B6 and B7 (medvae_tpu_torch/ops/csrc/groupnorm_swish.cu)
side by side on one card, at the 28² CVAE's (4096, 32, 28, 28) and
(4096, 128, 7, 7) and the flagship's (32, 1024, 28, 28) and (32, 128, 224, 224),
bf16.

    python scripts/gn_variants.py

Two kinds of variant. Source variants (VARIANTS below) are the committed
source with a few literal substitutions, built by nvcc with the port's flags
into build/groupnorm_swish_variants/; plan variants (PLANS) are the
committed build run on another plan than `gn_swish_plan`'s default (ring
stages, groups a span, cluster size), changed with dataclasses.replace and
recounted by `plan_smem`. Each is loaded with ctypes and timed with CUDA
events (median of 20 launches a round, rounds in turn so that clocks drift
alike). Prints one JSON line a variant and shape: the plans, B6 and B7 ms,
and the largest difference of its outputs from the committed build's
default. Last, a line with the host's time to plan B6 and B7 (the plan
cached by `plan_for`, or made afresh) and to call each wrapper with either,
at a small shape the card keeps up with. Needs the card and nvcc; it
imports no JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import sys
import time
from unittest import mock

import torch

import _variants  # puts the repo's root on sys.path

from medvae_tpu_torch.ops import groupnorm_swish as gs  # noqa: E402

KERNELS = ("gn_fwd_resident", "gn_bwd_resident", "gn_fwd_cluster", "gn_bwd_cluster", "gn_bwd_params")
IS_BULK = "  auto is_bulk = [&](int i) { return (elems(i) * (long long)sizeof(T)) % 16 == 0; };\n"
BULK_SLICE = "  const bool bulk = ((long long)L * sizeof(T)) % 16 == 0;  // then every slice and chunk is aligned\n"
VECTOR_LOOP = "  for (int v = v0 + t; v < v1; v += nt) {\n"
VARIANTS = {
    "committed": [],
    # every span and slice through threads' 16-byte loads and stores instead
    # of cp.async.bulk (resident: the producer warp's; cluster: the block's)
    "vector_loads": [(IS_BULK, "  auto is_bulk = [&](int i) { return false; };\n"),
                     (BULK_SLICE, "  const bool bulk = false;\n")],
    # the on-chip passes' vector loops unrolled 4 times
    "unroll_4": [(VECTOR_LOOP, "#pragma unroll 4\n" + VECTOR_LOOP)],
    # B6's cluster slices in one bulk load, or in eight; B7's in four
    "chunks_1": [("constexpr int kChunks = 4;", "constexpr int kChunks = 1;")],
    "chunks_8": [("constexpr int kChunks = 4;", "constexpr int kChunks = 8;")],
    "bwd_chunks_4": [("  constexpr int chunks = BWD ? 1 : kChunks;", "  constexpr int chunks = kChunks;")],
    # clusters of 16 blocks allowed (past the portable 8; plan "cluster_16")
    "cluster_16_allowed": [("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
                           ("  auto kernel = BWD ? &gn_bwd_cluster<T, VEC> : &gn_fwd_cluster<T, VEC>;\n",
                            "  auto kernel = BWD ? &gn_bwd_cluster<T, VEC> : &gn_fwd_cluster<T, VEC>;\n"
                            "  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")],
    # resident blocks held to the registers of 4, 5 or 6 blocks an SM (the
    # persistent grid follows: it is as many blocks as fit at once)
    "min_blocks_4": [(f"__launch_bounds__(kResidentThreads) gn_{p}_resident",
                      f"__launch_bounds__(kResidentThreads, 4) gn_{p}_resident") for p in ("fwd", "bwd")],
    "min_blocks_5": [(f"__launch_bounds__(kResidentThreads) gn_{p}_resident",
                      f"__launch_bounds__(kResidentThreads, 5) gn_{p}_resident") for p in ("fwd", "bwd")],
    "min_blocks_6": [(f"__launch_bounds__(kResidentThreads) gn_{p}_resident",
                      f"__launch_bounds__(kResidentThreads, 6) gn_{p}_resident") for p in ("fwd", "bwd")],
}
# diagnostics (timing only, wrong output), resident: the compute warps skip
# their groups (memory alone), or the producer moves no bytes (compute alone)
LOADS = ("          mbar_expect_tx(full(i), bytes * (BWD ? 2 : 1));\n"
         "          bulk_load(smem_u32(dst), x + off, bytes, full(i));\n"
         "          if (BWD) bulk_load(smem_u32(dst + cap), g + off, bytes, full(i));\n")
VARIANTS["memory_only"] = [("      for (int gi = 0; gi < n_in; ++gi) {", "      for (int gi = 0; gi < 0; ++gi) {"),
                           ("      for (int base = warp * per_warp; base < n_in;", "      for (int base = warp * per_warp; base < 0;")]
VARIANTS["compute_only"] = [(LOADS, "          mbar_arrive(full(i));\n"),
                            ("          bulk_store(out + off, smem_u32(stage_x(i)), (uint32_t)(n_el * sizeof(T)));\n", "")]
# the plan variants each source variant runs besides "default"
SOURCE_PLANS = {"min_blocks_4": ("lanes_x2",), "min_blocks_5": ("span_half",), "min_blocks_6": ("span_half", "span_quarter"),
                "cluster_16_allowed": ("cluster_16",)}
SHAPES = [(4096, 32, 28, 28), (4096, 128, 7, 7), (32, 1024, 28, 28), (32, 512, 56, 56),
          (32, 128, 224, 224)]
# plan variant -> the default plan's fields changed, where the instance has them
PLANS = {
    "default": {},
    "stages_3": {"stages": 3},
    "stages_4": {"stages": 4},
    "span_x2": {"span": 2.0},
    "span_half": {"span": 0.5},
    "span_quarter": {"span": 0.25},
    "span_half_stages_3": {"span": 0.5, "stages": 3},
    # twice or half the lanes a group, spans of as few groups as the block's
    # segments then need (fewer groups a block, more blocks an SM)
    "lanes_x2": {"lanes": 2.0},
    "lanes_half": {"lanes": 0.5},
    "cluster_2": {"cluster": 2},
    "cluster_4": {"cluster": 4},
    "cluster_8": {"cluster": 8},
    "cluster_16": {"cluster": 16},
}


def plan(x, groups, backward, changes):
    """The variant's plan, or None where it does not apply or does not fit."""
    base = gs.plan_for(x, groups, backward)
    kw = dict(changes)
    if base.instance == "resident" and "cluster" in kw or base.instance == "cluster" and "cluster" not in kw and kw:
        return None
    if "lanes" in kw:
        lanes = int(base.lanes * kw.pop("lanes"))
        if base.instance != "resident" or lanes not in (8, 16, 32):
            return None
        kw["lanes"] = lanes
        kw["groups_per_span"] = base.groups_per_span * base.lanes // lanes
    if "span" in kw:
        k = int(base.groups_per_span * kw.pop("span"))
        unit = 8 * 32 // base.lanes if base.lanes <= 32 else 1
        if k < unit or k % unit:
            return None
        kw["groups_per_span"] = k
    length = x.shape[1] // groups * x.shape[2] * x.shape[3]
    p = dataclasses.replace(base, **kw)
    p = dataclasses.replace(p, smem_bytes=gs.plan_smem(p, length, x.element_size(), backward))
    if p.smem_bytes > gs.SMEM_MAX or p.instance == "resident" and (p.groups_per_span * length * x.element_size()) % 16:
        return None
    return p


def planner_host_us(shape, calls: int = 2000) -> dict:
    """Host microseconds, bf16 at `shape`: a plan from `plan_for` (cached)
    and one made afresh (the card's properties read and gn_swish_plan run),
    for B6 and B7; and a call of each wrapper (check, plan, allocate, launch)
    with either, at a shape small enough that the card keeps up."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    w, b = torch.ones(shape[1], device="cuda"), torch.zeros(shape[1], device="cuda")
    _, mean, rstd = gs.group_norm_swish_fwd(x, w, b, 32, 1e-6)
    cached = gs.plan_for

    def afresh(t, groups, backward=False, instance=None):
        sms = torch.cuda.get_device_properties(t.device).multi_processor_count
        return gs.gn_swish_plan(t.shape, t.element_size(), groups, sms, backward, instance)

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for how, plan_fn in (("cached", cached), ("afresh", afresh)):
        for which in ("fwd", "bwd"):
            out[f"plan_{which}_{how}_us"] = host_us(lambda: plan_fn(x, 32, which == "bwd"))
        with mock.patch.object(gs, "plan_for", plan_fn):
            out[f"wrapper_fwd_{how}_us"] = host_us(lambda: gs.group_norm_swish_fwd(x, w, b, 32, 1e-6))
            out[f"wrapper_bwd_{how}_us"] = host_us(lambda: gs.group_norm_swish_bwd(x, w, b, g, mean, rstd))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gn_variants: no CUDA device", file=sys.stderr)
        return 2
    built = _variants.build_variants("groupnorm_swish.cu", VARIANTS, KERNELS)
    libs = {name: ctypes.CDLL(lib) for name, (lib, _, _) in built.items()}
    fns = {(name, kernel): gs.bind(lib, kernel, torch.bfloat16)
           for name, lib in libs.items() for kernel in ("gn_swish_fwd", "gn_swish_bwd")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    smi = _variants.gpu()
    for shape in SHAPES:
        b, c, h, w = shape
        groups = 32
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).bfloat16()
        g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        gamma = torch.rand((c,), generator=gen, device="cuda") + 0.5
        beta = torch.randn((c,), generator=gen, device="cuda") * 0.1
        _, mean, rstd = gs.group_norm_swish_fwd(x, gamma, beta, groups, 1e-6)
        keys, plans, outs = [], {}, {}
        for src in VARIANTS:
            for pname, overrides in PLANS.items():
                if src != "committed" and pname != "default" and pname not in SOURCE_PLANS.get(src, ()):
                    continue
                if src == "committed" and any(pname in plans_of for plans_of in SOURCE_PLANS.values()):
                    continue
                pair = (plan(x, groups, False, overrides), plan(x, groups, True, overrides))
                if pair == (None, None):
                    continue
                plans[(src, pname)] = pair
                outs[(src, pname)] = [torch.empty_like(x), torch.empty_like(mean), torch.empty_like(rstd),
                                      torch.empty_like(x), torch.empty_like(gamma), torch.empty_like(gamma)]
                keys += [(src, pname, which) for which, p in zip(("fwd", "bwd"), pair) if p is not None]

        def launch(key):
            src, pname, which = key
            p = plans[(src, pname)][which == "bwd"]
            y, m, r, dx, dg, db = outs[(src, pname)]
            ws = gs._workspace(p, x, groups, which == "bwd")
            args = ((x, gamma, beta, y, m, r, ws) if which == "fwd"
                    else (x, g, gamma, beta, mean, rstd, dx, dg, db, ws))
            eps = (1e-6,) if which == "fwd" else ()
            _variants.check(fns[(src, "gn_swish_" + which)](*(t.data_ptr() for t in args), b, c, h * w,
                                                            groups, *p.args(), *eps, stream),
                            f"variant {src}/{pname} {which}")

        times = _variants.time_rounds(keys, launch, calls=20)
        ref = outs[("committed", "default")]
        for (src, pname), pair in plans.items():
            print(json.dumps({
                "variant": src, "plan": pname, "shape": list(shape), "dtype": "bfloat16", "gpu": smi,
                "ptxas": built[src][1] if pname == "default" else None,
                "fwd_plan": pair[0] and vars(pair[0]), "bwd_plan": pair[1] and vars(pair[1]),
                "fwd_ms": times.get((src, pname, "fwd")), "bwd_ms": times.get((src, pname, "bwd")),
                "max_abs_diff_from_committed": [(o.float() - r.float()).abs().max().item()
                                                for o, r, p in zip(outs[(src, pname)], ref,
                                                                   (pair[0],) * 3 + (pair[1],) * 3)
                                                if p is not None],
            }), flush=True)
        del x, g, outs
        torch.cuda.empty_cache()
    for shape in ((64, 128, 7, 7),):
        print(json.dumps({"planner": list(shape), "dtype": "bfloat16", "gpu": smi,
                          **planner_host_us(shape)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
