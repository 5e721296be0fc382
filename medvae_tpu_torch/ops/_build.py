"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `ops/csrc/<name>.cu` is compiled on its own by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `build/medvae_tpu_torch/<name>-<hash>.so` beside the package, where the
hash covers the source, the shared headers `csrc/*.cuh` and the flags, so an
edited kernel or header is rebuilt and an unchanged one is reused. The
sources expose a plain C interface (no PyTorch headers), which keeps a build
to seconds. ptxas's report of each kernel (registers, spills) is kept beside
the library as `<name>-<hash>.log` and read by `ptxas_stats`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "medvae_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
            "are built on the machine with the GPU"
        )
    return str(path)


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every header in
    csrc/ (a source may include any of them) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """The library of csrc/<name>.cu, compiled unless an up-to-date one
    exists. Raises with nvcc's output on failure."""
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)  # before the library, which marks the build done
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def parse_ptxas(report: str) -> Dict[str, dict]:
    """Registers and spill-store bytes by (mangled) kernel name from
    `nvcc -Xptxas -v` output: ptxas names a function ("Compiling entry
    function", "Function properties for") and then gives its spills and
    registers."""
    stats: Dict[str, dict] = {}
    current = None
    for line in report.splitlines():
        named = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
        if named:
            current = named[1]
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores")):
            found = re.search(pattern, line)
            if found and current:
                stats.setdefault(current, {}).setdefault(key, int(found[1]))
    return stats


def report(name: str) -> str:
    """nvcc's output (ptxas's report) of the build of csrc/<name>.cu, built
    first if needed."""
    build(name)
    return _target(name).with_suffix(".log").read_text()


def ptxas_stats(name: str) -> Dict[str, dict]:
    """`parse_ptxas` of csrc/<name>.cu's build report."""
    return parse_ptxas(report(name))


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, compiling it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def last_failure(name: str) -> str:
    """The words csrc/<name>.cu's library left for the last failure of one
    of its launchers on the calling thread (hopper.cuh's
    `medvae_last_failure`)."""
    fn = load(name).medvae_last_failure
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return (fn() or b"").decode(errors="replace")
