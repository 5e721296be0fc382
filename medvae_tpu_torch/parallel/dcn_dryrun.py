"""Multi-node (dcn) dry run: 2 "nodes" × 2 ranks on this machine
(counterpart of scripts/dcn_dryrun.py).

    python -m medvae_tpu_torch.parallel.dcn_dryrun [--device cuda|cpu]

The ranks run on the card unless `--device cpu` asks for the CPU; the four
share the card(s) of this host, so their collectives go through gloo
unless each has a card of its own (core/mesh.py). Four ranks start with
LOCAL_WORLD_SIZE 2 (parallel/launch.py), so the mesh
of core/mesh.py is (dcn=2, data=2, model=1) with one dcn row a node. Each
rank feeds its own rows of every global batch through `DeviceFeeder`, and
the data-parallel step pmeans over the (dcn, data) batch group. A 16²
ConditionalVAE trains one epoch of 64 rows at global batch 16 (four steps);
every rank prints the same finite loss, and the parent prints
`DCN dryrun: OK`. `run(dcn=False)` runs the same job on a one-node
(data=4) mesh, which gives the same losses.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List

import numpy as np
import torch

N_ROWS, BATCH = 64, 16


def _worker(rank: int, dcn: bool) -> List[float]:
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.data.medmnist import SplitArrays
    from medvae_tpu_torch.data.pipeline import DeviceFeeder
    from medvae_tpu_torch.parallel.shard_map_step import build_dp_train_step, rank_seed
    from medvae_tpu_torch.train.optim import build_optimizer
    from medvae_tpu_torch.train.state import create_train_state

    spec = core_mesh.MeshSpec(data=2, model=1, dcn=2) if dcn else core_mesh.MeshSpec(data=4, model=1)
    mesh = core_mesh.create_mesh(spec, core_mesh.current())
    device = mesh.dist.device
    expected = ("dcn", "data", "model") if dcn else ("data", "model")
    if mesh.axis_names != expected:
        raise RuntimeError(f"mesh axes {mesh.axis_names}, expected {expected}")
    model = init_weights(build_model(dict(_target_="medvae_tpu.models.ConditionalVAE", input_channels=3,
                                          latent_dim=4, hidden_channels=8, ch_mult=[1, 2], num_res_blocks=1,
                                          attn_resolutions=[], dropout=0.0, resolution=16,
                                          condition_method="concat"), "fp32", device, train=True), seed=0)
    tx = build_optimizer({"type": "adam", "lr": 1e-3}, None)
    state = create_train_state(model, tx)
    step = build_dp_train_step(model, {"type": "vae"}, tx, mesh, max_channels=3)
    # the same arrays on every rank; the feeder takes each rank's rows
    rs = np.random.RandomState(0)
    arrays = SplitArrays(images=rs.randint(0, 255, (N_ROWS, 16, 16, 3), np.uint8),
                         labels=np.zeros((N_ROWS,), np.int32),
                         modality_idx=(np.arange(N_ROWS) % 5).astype(np.int32), channels=3)
    feeder = DeviceFeeder(arrays, BATCH, device, shuffle=True, mesh=mesh)
    generator = torch.Generator(device=device)
    losses = []
    for batch in feeder.epoch(0):
        if batch["image_u8"].shape[0] != BATCH // mesh.batch_extent:
            raise RuntimeError(f"rank {rank} took {batch['image_u8'].shape[0]} rows")
        generator.manual_seed(rank_seed(1, state.step, mesh))
        state, metrics = step(state, batch, generator)
        losses.append(float(metrics["train/loss"]))
    if len(losses) != N_ROWS // BATCH or not all(np.isfinite(losses)):
        raise RuntimeError(f"rank {rank}: losses {losses}")
    node = rank // 2 if dcn else 0
    print(f"node {node} rank {rank}: dcn dryrun ok loss={losses[-1]:.6f} steps={len(losses)} "
          f"rows={BATCH // mesh.batch_extent}", flush=True)
    return losses


def run(dcn: bool = True, timeout: float = 300.0, device: str = "cuda") -> List[List[float]]:
    """Every rank's losses, from four ranks on `device` as two nodes (`dcn`)
    or one. Raises when the card is asked for and missing."""
    from medvae_tpu_torch.parallel.launch import spawn

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("the dcn dry run asks for the card and there is no CUDA device; pass --device cpu")
    with tempfile.TemporaryDirectory(prefix="medvae_dcn_") as store:
        return spawn(_worker, 4, store_dir=store, args=(dcn,), local_world=2 if dcn else 4, timeout=timeout,
                     device=device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="2 nodes x 2 ranks on a (dcn=2, data=2) mesh")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    losses = run(dcn=True, device=parser.parse_args(argv).device)
    ok = all(l == losses[0] for l in losses)
    print("DCN dryrun:", "OK" if ok else "FAILED (the ranks' losses differ)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
