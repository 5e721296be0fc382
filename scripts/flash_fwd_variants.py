"""Time variants of kernel B1 (medvae_tpu_torch/ops/csrc/flash_fwd.cu) side
by side on one card, at the flagship's (32, 3136, 512) bf16 shape.

    python scripts/flash_fwd_variants.py

Each variant is the committed source with a few literal substitutions
(VARIANTS below), built by nvcc with the port's flags plus -Xptxas -v into
build/flash_fwd_variants/, loaded with ctypes and timed with CUDA events
(median of 20 launches a round, rounds in turn so that clocks drift alike).
Prints one JSON line a variant: its registers and spills as ptxas reports
them, ms without and with lse, and the largest difference of its output from
the committed build's (variants that skip work are for timing only).
Needs the card and nvcc; it imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from medvae_tpu_torch.ops import _build  # noqa: E402

SRC = ROOT / "medvae_tpu_torch" / "ops" / "csrc" / "flash_fwd.cu"
OUT = ROOT / "build" / "flash_fwd_variants"
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


def build(name: str, subs) -> tuple:
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise KeyError(f"variant {name}: {old[:60]!r} not in {SRC.name}")
        text = text.replace(old, new)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(SRC.parent), "-o", str(lib),
         str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    # registers and spills of the instance that takes c = 512
    kernel = "flash_fwd_bf16_kernelILi64E" if MMA_SYNC in subs else "flash_fwd_wgmma_kernelILi512E"
    # ptxas -v names a kernel ("Compiling entry function", "Function
    # properties for") and then gives its spills and registers
    stats, current = {}, None
    for line in proc.stdout.splitlines():
        named = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if named:
            current = named[1]
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores")):
            found = re.search(pattern, line)
            if found and current and kernel in current:
                stats.setdefault(key, int(found[1]))
    if len(stats) < 2:
        print(proc.stdout, file=sys.stderr)
    return str(lib), stats.get("registers"), stats.get("spill_store_bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))
    b, n, c = 32, 3136, 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, n, c), generator=gen, device="cuda").bfloat16() for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    fns, outs = {}, {}
    for name, (lib, _, _) in built.items():
        fn = ctypes.CDLL(lib).medvae_flash_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        outs[name] = (torch.empty_like(q), torch.empty((b, n), device="cuda"))

    def launch(name, with_lse):
        o, lse = outs[name]
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr() if with_lse else None, b, n, c, c ** -0.5, stream)
        if err:
            raise RuntimeError(f"variant {name}: CUDA error {err}")

    times = {(name, lse): [] for name in VARIANTS for lse in (False, True)}
    for _ in range(3):
        for key in times:
            launch(*key)
            torch.cuda.synchronize()
            for _ in range(20):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                launch(*key)
                end.record()
                end.synchronize()
                times[key].append(start.elapsed_time(end))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    ref = outs["committed"][0].float()
    for name, (_, regs, spill) in built.items():
        ms = statistics.median(times[(name, False)])
        print(json.dumps({
            "variant": name, "shape": [b, n, c], "gpu": smi, "registers": regs,
            "spill_store_bytes": spill, "ms": ms, "ms_with_lse": statistics.median(times[(name, True)]),
            "tflops_per_s": 4.0 * b * n * n * c / ms / 1e9,
            "max_abs_diff_from_committed": (outs[name][0].float() - ref).abs().max().item(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
