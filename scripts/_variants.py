"""What the kernel variants scripts (flash_fwd_variants.py,
flash_bwd_variants.py, attention_variants.py) share: building literal-
substitution variants of one CUDA source with the port's nvcc flags, binding
their C entries with ctypes, timing launches in alternating rounds with CUDA
events, and reading the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from medvae_tpu_torch.ops import _build  # noqa: E402

CSRC = ROOT / "medvae_tpu_torch" / "ops" / "csrc"


def substitute(source: str, name: str, subs) -> str:
    """csrc/`source` with variant `name`'s literal substitutions made;
    raises KeyError where one no longer matches the source."""
    text = (CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise KeyError(f"variant {name}: {old[:60]!r} not in {source}")
        text = text.replace(old, new)
    return text


def _build_one(src: Path, out: Path, name: str, subs, kernels: Sequence[str]) -> tuple:
    variant_src = out / f"{name}.cu"
    variant_src.write_text(substitute(src.name, name, subs))
    lib = out / f"{name}.so"
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(variant_src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    stats = {}
    for kernel, found in _build.parse_ptxas(proc.stdout).items():
        frag = next((k for k in kernels if k in kernel), None)
        if frag:
            stats.setdefault(frag, found)
    return str(lib), stats, "C7520" in proc.stdout


def build_variants(source: str, variants: Dict[str, list], kernels: Sequence[str]) -> Dict[str, tuple]:
    """Build every variant of csrc/`source` (name -> [(old, new), ...]
    substitutions) in parallel into build/<stem>_variants/. Returns name ->
    (library path, ptxas registers and spills of the kernels whose mangled
    names hold one of `kernels`, keyed by that fragment, whether ptxas
    serialized a wgmma (warning C7520))."""
    src = CSRC / source
    out = ROOT / "build" / f"{src.stem}_variants"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = pool.map(lambda kv: _build_one(src, out, kv[0], kv[1], kernels), variants.items())
        return dict(zip(variants, built))


def bind(lib: str, symbol: str, n_ptrs: int):
    """A kernel entry of the port's C interface: n_ptrs pointers, b, n, c,
    the scale and a stream; returns a CUDA error code."""
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_rounds(keys: Iterable, launch: Callable, calls: int, rounds: int = 3) -> Dict[object, float]:
    """Median ms of `launch(key)` for every key: `rounds` rounds, each a warm
    launch and then `calls` launches timed one by one with CUDA events, the
    keys in turn within a round so that clocks drift alike."""
    times: Dict[object, List[float]] = {key: [] for key in keys}
    for _ in range(rounds):
        for key in times:
            launch(key)
            torch.cuda.synchronize()
            for _ in range(calls):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                launch(key)
                end.record()
                end.synchronize()
                times[key].append(start.elapsed_time(end))
    return {key: statistics.median(ms) for key, ms in times.items()}


def gpu() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
