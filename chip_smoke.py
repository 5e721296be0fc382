"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:
  env      torch, CUDA, nvcc, and the card's name and power limit;
  build    compiles the kernel of medvae_tpu_torch/ops/csrc (timed);
  kernel   the flash-attention forward kernel against its plain PyTorch
           version on the card (bf16: max abs 4e-3 and relative L2 1e-2 at
           (32,3136,512), (2,784,1024), (2,1000,512); fp32: max abs and relative L2
           1e-4 at (2,3136,512)), and its time beside its bound, the plain version's
           and scaled_dot_product_attention's;
  serve    the full-width 224² flagship DisentangledConditionalVAE (random
           weights from a seed, bf16) behind InferenceEngine(buckets 1/8/32):
           reconstruct/encode/decode/sample requests with mixed modalities,
           the kernel's launches per chunk, then reconstruct latency per
           bucket (median, spread and every sample);
  parity   the same weights in fp32: card against CPU, and card bf16
           against card fp32;
  http     one /reconstruct, /encode and /sample through cli/serve.py;
  profile  device time by kernel and by layer for one bs-32 reconstruct
           (torch.profiler), and the card's idle share during it.
Then the card line from nvidia-smi, the kernels line, and
{"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

try:
    from medvae_tpu_torch.cli.serve import _b64_to_np, _np_to_b64, serve
    from medvae_tpu_torch.config.models import FLAGSHIP, build_model, init_weights
    from medvae_tpu_torch.ops import _build
    from medvae_tpu_torch.ops import flash_attention as fa
    from medvae_tpu_torch.ops.attention import reference_attention
    from medvae_tpu_torch.serve.engine import InferenceEngine
except ImportError as e:
    print(f"chip_smoke: the medvae_tpu_torch package is missing here ({e})", file=sys.stderr)
    raise SystemExit(3)

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12
REPS = 20
# kernel vs plain version: (max abs, relative L2) by dtype. The bf16 bar is
# ~4x the max error measured at the served shape and a fraction of a typical
# output there (|o| ~ 0.03 at n = 3136), so a kernel that drops a key tile
# fails it.
TOLERANCE = {torch.bfloat16: (4e-3, 1e-2), torch.float32: (1e-4, 1e-4)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median over `reps` single calls, each timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_samples_ms(fn, reps: int) -> list:
    """Wall times, in call order, of a call that ends on the host (results
    in numpy)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def torch_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def phase_env() -> str:
    smi = nvidia_smi_line()
    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60,
        check=True,
    ).stdout.strip().splitlines()[-1]
    emit({
        "phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "nvcc": nvcc, "gpu": smi,
        "device_count": torch.cuda.device_count(),
    })
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build("flash_fwd")
    _build.load("flash_fwd")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": path.name})


def phase_kernel() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, n, c, dtype):
        return [torch.randn((b, n, c), generator=gen, device="cuda").to(dtype) for _ in range(3)]

    checks = [((32, 3136, 512), torch.bfloat16), ((2, 784, 1024), torch.bfloat16),
              ((2, 1000, 512), torch.bfloat16), ((2, 3136, 512), torch.float32)]
    errs = {}
    for shape, dtype in checks:
        tol_abs, tol_rel = TOLERANCE[dtype]
        q, k, v = qkv(*shape, dtype)
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = torch_rel_l2(got, want)
        finite = bool(torch.isfinite(got).all())
        emit({"phase": "kernel", "shape": list(shape), "dtype": str(dtype).split(".")[-1],
              "max_abs_err": err, "rel_l2": rel, "tolerance_max_abs": tol_abs,
              "tolerance_rel_l2": tol_rel, "output_std": want.float().std().item(),
              "finite": finite})
        if not finite or not err <= tol_abs or not rel <= tol_rel:
            raise AssertionError(
                f"flash_fwd {shape} {dtype}: max abs err {err} (bar {tol_abs}), "
                f"relative L2 {rel} (bar {tol_rel})"
            )
        errs[(shape, dtype)] = err
        del q, k, v, got, want

    b, n, c = 32, 3136, 512
    q, k, v = qkv(b, n, c, torch.bfloat16)
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v))
    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
    )
    flops = 4.0 * b * n * n * c
    nbytes = 4.0 * b * n * c * q.element_size()  # q, k, v read once, o written once
    t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    row = {
        "shape": [b, n, c], "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes, "tflops_per_s": flops / ms / 1e9,
        "max_abs_err": errs[((b, n, c), torch.bfloat16)],
    }
    emit({"phase": "kernel", **row})

    # the routing question: the 784x1024 blocks stay on reference_attention by
    # the TPU's gate; time both paths there on the card
    q, k, v = qkv(32, 784, 1024, torch.bfloat16)
    emit({"phase": "kernel", "gate_shape": [32, 784, 1024], "dtype": "bfloat16",
          "kernel_ms": cuda_ms(lambda: fa.flash_attention(q, k, v)),
          "reference_attention_ms": cuda_ms(lambda: reference_attention(q, k, v))})
    return row


def build_engines():
    cpu_model = build_model(FLAGSHIP, "fp32", "cpu")
    init_weights(cpu_model, seed=0)
    state = cpu_model.state_dict()
    bf16 = build_model(FLAGSHIP, "bf16", "cuda")
    bf16.load_state_dict(state)
    fp32 = build_model(FLAGSHIP, "fp32", "cuda")
    fp32.load_state_dict(state)
    return (InferenceEngine(bf16, buckets=(1, 8, 32), device="cuda"),
            InferenceEngine(fp32, buckets=(1,), device="cuda"),
            InferenceEngine(cpu_model, buckets=(1,), device="cpu"))


# flash launches a chunk of each request makes on the flagship: the five 56²
# attention blocks, two in the encoder and three in the decoder
PER_CHUNK = {"reconstruct": 5, "encode": 2, "decode": 3, "sample": 3}


def phase_serve(engine) -> int:
    t0 = time.perf_counter()
    n_warm = engine.warmup()
    emit({"phase": "serve", "warmup_runs": n_warm,
          "warmup_seconds": round(time.perf_counter() - t0, 3)})
    rs = np.random.RandomState(0)
    res, c = int(engine.model.resolution), int(engine.model.max_channels)
    r = engine.model.encoder_out_res
    zdim = engine.model.total_latent_dim
    images = {n: rs.randint(0, 256, (n, res, res, c), np.uint8) for n in (1, 8, 37)}
    mods = {n: (np.arange(n) % 5).astype(np.int32) for n in (1, 8, 37)}
    z8 = rs.randn(8, r, r, zdim).astype(np.float32)
    requests = [
        ("reconstruct", 1, lambda: engine.reconstruct(images[1], modality=mods[1])),
        ("reconstruct", 8, lambda: engine.reconstruct(images[8], modality=mods[8])),
        ("reconstruct", 37, lambda: engine.reconstruct(images[37], modality=mods[37])),
        ("encode", 8, lambda: engine.encode(images[8], modality=mods[8])),
        ("decode", 8, lambda: engine.decode(z8, modality=mods[8])),
        ("sample", 8, lambda: engine.sample(8, modality=mods[8], seed=1)),
    ]
    fa.launches = 0  # the main path starts here
    for method, n, fn in requests:
        before = fa.launches
        out = fn()
        got = fa.launches - before
        chunks = len(list(engine._chunks(n)))
        arrays = out if isinstance(out, tuple) else (out,)
        want_shape = (n, r, r, zdim) if method == "encode" else (n, res, res, c)
        ok = all(a.shape == want_shape and np.isfinite(a).all() for a in arrays)
        emit({"phase": "serve", "method": method, "n": n, "chunks": chunks,
              "flash_launches": got, "shape": list(arrays[0].shape), "finite_and_shaped": ok})
        if not ok:
            raise AssertionError(f"{method}({n}): bad output {[a.shape for a in arrays]}")
        if got != PER_CHUNK[method] * chunks:
            raise AssertionError(
                f"{method}({n}): {got} flash launches, want {PER_CHUNK[method]} x {chunks}"
            )
    main_path_launches = fa.launches  # the main path ends here

    for b in engine.buckets:
        x, m = rs.randint(0, 256, (b, res, res, c), np.uint8), (np.arange(b) % 5).astype(np.int32)
        engine.reconstruct(x, modality=m)
        times = host_samples_ms(lambda: engine.reconstruct(x, modality=m), reps=max(5, 40 // b))
        ms = statistics.median(times)
        emit({"phase": "serve", "method": "reconstruct", "bucket": b,
              "ms_per_batch": ms, "images_per_sec": b / ms * 1e3,
              "min_ms": min(times), "max_ms": max(times), "samples_ms": times})
    return main_path_launches


def phase_parity(bf16_engine, fp32_engine, cpu_engine) -> None:
    res, c = int(fp32_engine.model.resolution), int(fp32_engine.model.max_channels)
    x = np.random.RandomState(1).randint(0, 256, (1, res, res, c), np.uint8)
    m = np.array([2], np.int32)
    card = fp32_engine.reconstruct(x, modality=m)
    cpu = cpu_engine.reconstruct(x, modality=m)
    half = bf16_engine.reconstruct(x, modality=m)
    row = {"phase": "parity", "fp32_card_vs_cpu_max_abs": float(np.abs(card - cpu).max()),
           "fp32_card_vs_cpu_rel_l2": rel_l2(card, cpu), "tolerance": 1e-3,
           "bf16_vs_fp32_card_rel_l2": rel_l2(half, card), "bf16_bound": 5e-2}
    emit(row)
    if not row["fp32_card_vs_cpu_rel_l2"] <= 1e-3:
        raise AssertionError(f"fp32 card vs CPU rel L2 {row['fp32_card_vs_cpu_rel_l2']}")
    if not row["bf16_vs_fp32_card_rel_l2"] <= 5e-2:
        raise AssertionError(f"bf16 vs fp32 rel L2 {row['bf16_vs_fp32_card_rel_l2']}")


def phase_http(engine) -> None:
    httpd = serve(engine, port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.load(resp)

    model = engine.model
    res, c, r = int(model.resolution), int(model.max_channels), model.encoder_out_res
    try:
        img = np.random.RandomState(2).randint(0, 256, (1, res, res, c), np.uint8)
        rec = _b64_to_np(post("/reconstruct", {"images_b64": _np_to_b64(img),
                                               "modality": "pathmnist", "output": "uint8"})["images_b64"])
        enc = post("/encode", {"images_b64": _np_to_b64(img), "modality": 1})
        mean = _b64_to_np(enc["mean_b64"])
        smp = _b64_to_np(post("/sample", {"num_samples": 2, "modality": [0, 4], "seed": 3})["images_b64"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    ok = (rec.shape == (1, res, res, c) and rec.dtype == np.uint8
          and mean.shape == (1, r, r, model.total_latent_dim)
          and smp.shape == (2, res, res, c) and np.isfinite(smp).all() and np.isfinite(mean).all())
    emit({"phase": "http", "reconstruct": list(rec.shape), "encode_mean": list(mean.shape),
          "sample": list(smp.shape), "ok": bool(ok)})
    if not ok:
        raise AssertionError("http round trips returned bad shapes")


# kernel-name fragments -> the layer a kernel belongs to, for the breakdown
_CATEGORIES = (
    ("flash_fwd", "flash_fwd (B1)"),
    ("Nhwc", "cudnn layout transforms"),
    ("Nchw", "cudnn layout transforms"),
    ("fprop", "convolution"),
    ("conv", "convolution"),
    ("gemm", "matmul"),
    ("group_norm", "group norm"),
    ("GroupNorm", "group norm"),
    ("softmax", "softmax"),
)


def _category(name: str) -> str:
    for frag, cat in _CATEGORIES:
        if frag in name:
            return cat
    return "elementwise / copy / other"


def phase_profile(engine) -> None:
    """Device time by kernel over one bs-32 reconstruct (torch.profiler),
    beside the same call's unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res, c = int(engine.model.resolution), int(engine.model.max_channels)
    x = np.random.RandomState(3).randint(0, 256, (32, res, res, c), np.uint8)
    m = (np.arange(32) % 5).astype(np.int32)
    wall_ms = statistics.median(host_samples_ms(lambda: engine.reconstruct(x, modality=m), reps=3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.reconstruct(x, modality=m)
    kernels = [(e.self_device_time_total / 1e3, e.key, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    by_cat = {}
    for ms, name, _ in kernels:
        by_cat[_category(name)] = by_cat.get(_category(name), 0.0) + ms
    emit({"phase": "profile", "bucket": 32, "wall_ms": wall_ms,
          "device_busy_ms": busy if kernels else "not measured",
          "idle_share": 1.0 - busy / wall_ms if kernels else "not measured",
          "by_layer_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
          "top": [{"kernel": k[:80], "ms": ms, "calls": n} for ms, k, n in kernels[:10]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    kernel = phase_kernel()
    bf16_engine, fp32_engine, cpu_engine = build_engines()
    launches = phase_serve(bf16_engine)
    phase_parity(bf16_engine, fp32_engine, cpu_engine)
    phase_http(bf16_engine)
    phase_profile(bf16_engine)
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "medvae_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "medvae_tpu/ops/flash_attention.py:208",
        "launches": launches, "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
