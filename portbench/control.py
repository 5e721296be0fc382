"""The controls of the comparisons that decide `correct`, read on the card at
a cell's own size (the benchmark's runs never run them):

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--device cuda]

For each seed it prints one JSON line of the cell's compared numbers for:

* `control`: the plain reference put in the program's place, its conv and
  dense operands rounded to fp8 e4m3 (reference/operands.py), the
  precision one step below the configurations' bf16, held against the
  fp32 reference;
* training cells also `half_batch`: the reference fed the first half of
  each batch (the loss's mean taken over the rest) against the whole
  batch; a state left unchanged reads 1 on `change_gap` by construction
  (compare.train_gaps) and needs no run;
* serving and evaluation cells also `swapped`: each sampled request's (or
  batch's) answer held against its neighbour's reference, as when a
  result goes to the wrong request.

The inputs are the runs' own, made from the seed: the same split, noise and
draws (training takes `check_steps` batches of distinct rows in a seeded
order, as the feeder would give them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _split(cell, seed, dev, rows):
    from portbench import data
    from portbench.common import sub_seed
    from portbench.reference import runner

    cfg = cell["model"]
    return data.make_split(rows, int(cfg["data"]["size"]), int(cfg["data"]["n_modalities"]),
                           sub_seed(seed, runner.DATA_STREAM), dev)


def train_control(cell, seed, dev):
    import numpy as np

    from portbench import compare, data
    from portbench.reference import runner

    cfg, mix = cell["model"], cell["mix"]
    bs, steps = int(cfg["data"]["batch_size"]), int(mix["check_steps"])
    split = _split(cell, seed, dev, int(mix["split_rows"]))
    order = np.random.default_rng(seed % (1 << 63)).permutation(len(split["images"]))[:bs * steps]
    shape = runner.noise_shape(cfg, bs)
    spe = len(split["images"]) // bs
    keys = tuple(mix["loss_keys"])

    def batches(rows_per_batch):
        out = []
        for i in range(steps):
            rows = order[i * bs:(i + 1) * bs][:rows_per_batch]
            b = data.batch_of(split, list(rows), dev)
            noise, draws = runner.step_inputs(shape, seed, i, dev, bool(cfg["data"]["augment_train"]))
            b["noise"] = noise[:rows_per_batch]
            b["draws"] = None if draws is None else {k: v[:rows_per_batch] for k, v in draws.items()}
            out.append(b)
        return out

    ref = runner.train_readings(cfg, seed, batches(bs), dev, spe, "fp32", keys)
    fp8 = runner.train_readings(cfg, seed, batches(bs), dev, spe, "fp8", keys)
    half = runner.train_readings(cfg, seed, batches(bs // 2), dev, spe, "fp32", keys)
    leaves = mix.get("grad_leaves", "")
    return {"control": compare.train_gaps(fp8, ref, leaves), "half_batch": compare.train_gaps(half, ref, leaves)}


def serve_control(cell, seed, dev):
    import numpy as np
    import torch

    from portbench import compare, weights
    from portbench.common import sub_seed
    from portbench.reference import model as ref_model
    from portbench.reference import runner
    from portbench.reference.operands import operand_format

    cfg, mix = cell["model"], cell["mix"]
    pool = _split(cell, seed, dev, int(mix["pool_images"]))["images"]
    rng = np.random.default_rng(seed % (1 << 63))
    n = int(mix["requests_sample"])
    img = rng.choice(len(pool), n, replace=False)
    midx = rng.integers(0, int(cfg["data"]["n_modalities"]), n)
    model = ref_model.build(cfg["model"], dev, train=False)
    weights.load(model, weights.make(runner.model_spec(cfg), sub_seed(seed, runner.MODEL_STREAM), dev))
    outs = {"fp32": [], "fp8": []}
    block = int(mix.get("reference_block", 16))
    with torch.no_grad():
        for fmt in outs:
            for lo in range(0, n, block):
                x = torch.as_tensor(pool[img[lo:lo + block]], device=dev).float() / 255.0 * 2.0 - 1.0
                m = torch.as_tensor(midx[lo:lo + block], device=dev)
                with operand_format(fmt):
                    outs[fmt].append(runner._reconstruct(model, x, m).float())
    want, fp8 = torch.cat(outs["fp32"]), torch.cat(outs["fp8"])
    return {"control": {"recon_rel_l2": compare.max_rel_l2(list(zip(fp8, want)))},
            "swapped": {"recon_rel_l2": compare.max_rel_l2(list(zip(want.roll(1, 0), want)))}}


def eval_control(cell, seed, dev):
    import torch

    from portbench import compare, data, weights
    from portbench.common import sub_seed
    from portbench.reference import model as ref_model
    from portbench.reference import runner
    from portbench.reference.metrics import kl_metrics, latent_metrics, reconstruction_metrics
    from portbench.reference.operands import operand_format
    from portbench.reference.preprocess import preprocess
    from portbench.reference.step import make_forward_fn

    cfg, mix = cell["model"], cell["mix"]
    bs = int(cfg["data"]["batch_size"])
    split = _split(cell, seed, dev, int(mix["split_rows"]))
    model = ref_model.build(cfg["model"], dev, train=False)
    weights.load(model, weights.make(runner.model_spec(cfg), sub_seed(seed, runner.MODEL_STREAM), dev))
    forward = make_forward_fn(model)
    shape = runner.noise_shape(cfg, bs)
    pairs, swapped = [], []
    gaps = {"psnr_gap_db": 0.0, "ssim_gap": 0.0, "metric_rel_gap": 0.0}
    with torch.no_grad():
        for i in range(int(mix["batches_sample"])):
            b = data.batch_of(split, list(range(i * bs, (i + 1) * bs)), dev)
            x = preprocess(b, None, augment=False, max_channels=3, dtype=torch.float32)
            gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 2000 + i))
            noise = torch.randn(shape, generator=gen, device=dev)
            got = {}
            for fmt in ("fp32", "fp8"):
                with operand_format(fmt):
                    out = forward(x, {**b, "noise": noise}, None)
                rec = out["reconstruction"].float()
                got[fmt] = (rec, {**reconstruction_metrics(rec, x, b["valid"]),
                                  **kl_metrics(out["mean"], out["logvar"], b["valid"]),
                                  **latent_metrics(out["z"], b["valid"])})
            pairs.append((got["fp8"][0], got["fp32"][0]))
            swapped.append((got["fp32"][0].roll(1, 0), got["fp32"][0]))
            gaps["psnr_gap_db"] = max(gaps["psnr_gap_db"], abs(float(got["fp8"][1]["psnr"] - got["fp32"][1]["psnr"])))
            gaps["ssim_gap"] = max(gaps["ssim_gap"], abs(float(got["fp8"][1]["ssim"] - got["fp32"][1]["ssim"])))
            for k in ("mse", "kl_total", "latent_std"):
                w = float(got["fp32"][1][k])
                gaps["metric_rel_gap"] = max(gaps["metric_rel_gap"], abs(float(got["fp8"][1][k]) - w) / max(abs(w), 1e-12))
    return {"control": {"recon_rel_l2": compare.max_rel_l2(pairs), **gaps},
            "swapped": {"recon_rel_l2": compare.max_rel_l2(swapped)}}


KINDS = {"train_loop": train_control, "open_loop_serve": serve_control, "eval_loop": eval_control}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench.common import cell_spec

    cell = cell_spec(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    fn = KINDS[cell["mix"]["kind"]]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = fn(cell, seed, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t,
                          **out}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
