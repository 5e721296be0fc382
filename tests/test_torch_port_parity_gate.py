"""chip_smoke's parity gate (dp2_card, tp2_card) on the CPU.

`chip_smoke.parity_run` takes PARITY_STEPS of the Trainer's own step on two
gloo ranks and on one rank, in fp32 and in bf16 compute, and
`chip_smoke.parity_gate` holds the two against each other. Here the gate
holds on the port as it is, and fails when a fault is planted at run time
in the ranks' parallel step:

  * grads_not_averaged: the data-parallel step skips the gradients' pmean
    over the batch group (each rank applies its own rows' gradient);
  * input_grads_not_summed: a column-parallel layer's input gradient is not
    summed over the model group (`tensor_parallel.sum_gradients`);
  * gather_without_sum: the latent's gather takes its rows of the cotangent
    without summing the ranks' (1/N of the cross-rank term of the
    flagship's separation and contrastive losses).

The runs are chip_smoke's at the sandbox's size: the quick CVAE and the
quick flagship at 28², and the 128² BaseVAE of tp2_card at 32² and width
32. Run as a script, it prints each case's gate row:

    JAX_PLATFORMS=cpu python tests/test_torch_port_parity_gate.py
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240
CASES = [("none", "cvae"), ("grads_not_averaged", "cvae"), ("input_grads_not_summed", "base"),
         ("gather_without_sum", "flagship")]


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    cs = importlib.import_module("chip_smoke")
    cs.PARITY_BATCHES.setdefault("base", _base_batch)
    return cs


def _base_batch() -> dict:
    rs = np.random.RandomState(5)
    return {"image_u8": torch.from_numpy(rs.randint(0, 255, (8, 32, 32, 1), np.uint8)),
            "modality_idx": torch.zeros((8,), dtype=torch.int32), "channels": torch.ones((8,), dtype=torch.int32)}


def _runs(cs) -> dict:
    """{name: (overrides, the two-rank mesh)}: chip_smoke's parity runs."""
    base = [*cs.PARITY, "experiment=chest_base_vae", "model.resolution=32", "data.size=32", "data.batch_size=8",
            "model.hidden_channels=32", "+model.remat=false", "early_stopping.enabled=false",
            "training.log_images_every_n_epochs=0"]
    return {"cvae": (cs.DP2_PARITY["cvae"], "mesh.data=2"), "flagship": (cs.DP2_PARITY["flagship"], "mesh.data=2"),
            "base": (base, "mesh.model=2")}


def _plant(fault: str) -> None:
    from medvae_tpu_torch.parallel import collectives, shard_map_step, tensor_parallel

    if fault == "grads_not_averaged":
        shard_map_step.pmean = lambda tensors, group: list(tensors)
    elif fault == "input_grads_not_summed":
        tensor_parallel.sum_gradients = lambda x, group: x
    elif fault == "gather_without_sum":
        def backward(ctx, g):
            r = collectives.group_rank(ctx.group)
            return g[r * ctx.rows:(r + 1) * ctx.rows], None

        collectives._GatherRows.backward = staticmethod(backward)


def _rank(rank: int, fault: str, name: str, by_precision: dict) -> dict:
    """One rank of the two-rank runs, the fault planted first."""
    _plant(fault)
    cs = _chip_smoke()
    out = {}
    for precision, overrides in by_precision.items():
        run = cs.parity_run(name, overrides)
        out[precision] = {k: run[k] for k in ("init", "final", "history")}
    return out


def _one_rank(cs, name: str, data_dir: str, work: str) -> dict:
    overrides, _ = _runs(cs)[name]
    out = {}
    for p in cs.PARITY_PRECISIONS:
        with contextlib.redirect_stdout(io.StringIO()):
            out[p] = cs.parity_run(name, [*overrides, "device=cpu", f"data_dir={data_dir}", f"precision={p}",
                                          f"work_dir={work}/one_{name}_{p}"])
    return out


def gate_row(cs, fault: str, name: str, one: dict, data_dir: str, work: str) -> dict:
    """parity_gate of the two ranks (`fault` planted in them) against `one`."""
    from medvae_tpu_torch.parallel.launch import spawn

    overrides, mesh = _runs(cs)[name]
    by_precision = {p: [*overrides, "device=cpu", f"data_dir={data_dir}", f"precision={p}",
                        f"work_dir={work}/two_{fault}_{name}_{p}", mesh] for p in cs.PARITY_PRECISIONS}
    two = spawn(_rank, 2, store_dir=f"{work}/store_{fault}_{name}", args=(fault, name, by_precision),
                timeout=RANK_TIMEOUT)[0]
    return cs.parity_gate(two, one)


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    """chip_smoke, a data dir, a work dir and the one-rank runs by name
    (made here first, so the ranks find the synthetic data written)."""
    cs = _chip_smoke()
    data, work = str(tmp_path_factory.mktemp("data")), str(tmp_path_factory.mktemp("work"))
    ones = {name: _one_rank(cs, name, data, work) for name in sorted({n for _, n in CASES})}
    return cs, data, work, ones


@pytest.mark.parametrize("fault,name", CASES)
def test_parity_gate_holds_and_fails_on_a_planted_fault(setting, fault, name):
    cs, data, work, ones = setting
    row = gate_row(cs, fault, name, ones[name], data, work)
    if fault == "none":
        assert row["ok"], row
        return
    assert not row["ok"], row
    # far past both precisions' bars, not at their edge
    assert row["fp32"]["update_rel_l2"] > 100 * cs.PARITY_FP32_BARS["update"], row
    assert row["bf16"]["two_from_fp32"] > cs.PARITY_BF16_FACTOR * row["bf16"]["one_from_fp32"], row


if __name__ == "__main__":
    torch.set_num_threads(2)
    cs = _chip_smoke()
    with tempfile.TemporaryDirectory() as data, tempfile.TemporaryDirectory() as work:
        ones = {}
        for fault, name in CASES + [("none", "flagship"), ("none", "base")]:
            if name not in ones:
                ones[name] = _one_rank(cs, name, data, work)
            print(fault, name, json.dumps(gate_row(cs, fault, name, ones[name], data, work)), flush=True)
