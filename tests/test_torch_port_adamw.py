"""The fused AdamW route's gate, counters and plain route on the CPU
(ops/adamw.py, train/optim.py:Optimizer.apply_). The kernels themselves run
only on the card (tests/test_torch_port_cuda.py)."""


import dataclasses
import importlib
import sys
from pathlib import Path

import pytest
import torch

from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.ops import _build, adamw
from medvae_tpu_torch.train import optim
from medvae_tpu_torch.train.step import _apply

SHAPES = [(3, 5), (7,), (2, 3, 3, 3), (1,)]


@pytest.fixture(autouse=True)
def clean_store():
    tracing.reset()
    yield
    tracing.reset()
    tracing.enable(None)


def _tensors(dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype) for s in SHAPES]


def _case(kind="adamw", clip=1.0, seed=0):
    tx = optim.build_optimizer({"type": kind, "lr": 1e-2, "weight_decay": 1e-3, "betas": (0.5, 0.999)},
                               {"type": "cosine", "T_max": 4}, gradient_clip_val=clip)
    params = _tensors(seed=seed)
    return tx, params, tx.init(params)


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_route_gate_on_the_cpu(kind):
    """On the CPU every update takes the plain chain: the kernels run on a
    CUDA device only (the gate's other decisions are held on the card, in
    tests/test_torch_port_cuda.py)."""
    tx, params, state = _case(kind)
    nu = state.nu or [torch.zeros_like(p) for p in params]
    assert not adamw.fused_route(tx.kind, tx.norm is optim.global_norm, _tensors(seed=1), state.mu, nu, params)


@pytest.mark.parametrize("kind, clip", [("adam", 1.0), ("adamw", 1.0), ("adamw", None), ("sgd", 0.5)])
def test_apply_in_place_equals_apply_then_add(kind, clip):
    """`apply_` on the plain route (the CPU) leaves params and moments bit for
    bit where `apply` and the step's add leave them, step after step, the
    clip engaged on the second (gradients ×100)."""
    lr_scale = torch.tensor(0.5)
    tx, params, state = _case(kind, clip)
    tx2, params2, state2 = _case(kind, clip)
    for step in range(3):
        grads = [g * (100.0 if step == 1 else 1e-3) for g in _tensors(seed=10 + step)]
        for t, s in ((tx, state), (tx2, state2)):
            t.prepare(s)
        tx.apply_(grads, state, params, lr_scale)
        _apply(params2, tx2.apply(grads, state2, params2), lr_scale)
        state.count += 1
        state2.count += 1
        for a, b in zip(params + state.mu + state.nu, params2 + state2.mu + state2.nu):
            assert torch.equal(a, b)


def test_apply_in_place_hands_the_plain_route_its_add():
    tx, params, state = _case()
    tx.prepare(state)
    seen = []
    tx.apply_(_tensors(seed=1), state, params, torch.tensor(1.0), add=lambda p, u, s: seen.append(len(u)))
    assert seen == [len(SHAPES)]


@pytest.mark.parametrize("kind, clip, per_element", [("adamw", 1.0, 32), ("adam", None, 28), ("sgd", 1.0, 24),
                                                     ("sgd", None, 20)])
def test_counters_while_tracing(kind, clip, per_element):
    """One `optim.plain` a call on the CPU and the least bytes of the update,
    only while tracing records."""
    tx, params, state = _case(kind, clip)
    tx.prepare(state)
    tx.apply_(_tensors(seed=1), state, params, torch.tensor(1.0))
    assert not any(k.startswith("optim.") for k in tracing.counters())
    tracing.enable(True)
    for _ in range(2):
        tx.apply_(_tensors(seed=1), state, params, torch.tensor(1.0))
    numel = sum(p.numel() for p in params)
    got = {k: v for k, v in tracing.counters().items() if k.startswith("optim.")}
    assert got == {"optim.plain": 2, "optim.least_bytes": 2 * per_element * numel}


def test_fused_route_wiring(monkeypatch):
    """Where the gate takes the call, `apply_` counts `optim.fused`, makes the
    workspace once and hands the kernels the optimizer's constants and the
    step's device scalars; the plain chain does not run."""
    calls = []
    monkeypatch.setattr(adamw, "fused_route", lambda *a: True)
    monkeypatch.setattr(adamw, "adam_", lambda *a: calls.append(a))
    monkeypatch.setattr(optim.Optimizer, "apply", lambda *a: pytest.fail("the plain chain ran"))
    tx, params, state = _case("adamw", 1.0)
    assert state.workspace is None  # made at the first fused update
    tracing.enable(True)
    lr_scale = torch.tensor(0.25)
    for _ in range(2):
        tx.prepare(state)
        tx.apply_(_tensors(seed=1), state, params, lr_scale)
    (g, mu, nu, ps, ws, h), second = calls[0], calls[1]
    assert mu is state.mu and nu is state.nu and ps is params and ws is second[4] is state.workspace
    assert ws.sizes == tuple(p.numel() for p in params) and ws.groups == [([0, 1, 2, 3], 0)] and ws.blocks == 4
    assert (h.b1, h.b2, h.eps, h.weight_decay, h.decay, h.clip) == (0.5, 0.999, 1e-8, 1e-3, True, 1.0)
    assert h.neg_lr is state.scalars["neg_lr"] and h.bc2 is state.scalars["bc2"] and h.lr_scale is lr_scale
    assert tracing.counters()["optim.fused"] == 2 and "optim.plain" not in tracing.counters()


def test_workspace_plan():
    """Launches of at most MAX_TENSORS non-empty tensors, one block a chunk
    of CHUNK elements, the partials one a block."""
    sizes = [adamw.CHUNK * 2 + 1] + [0] + [5] * 70
    ws = adamw.Workspace.of([torch.zeros(n) for n in sizes])
    assert [len(idx) for idx, _ in ws.groups] == [64, 7]
    assert ws.groups[0][0][:2] == [0, 2] and ws.groups[1] == (list(range(65, 72)), 3 + 63)
    assert ws.blocks == 3 + 70 and ws.partials.shape == (73,) and ws.partials.dtype == torch.float64
    assert ws.fits([torch.zeros(n) for n in sizes]) and not ws.fits([torch.zeros(n) for n in sizes[:-1]])


def test_module_imports_and_plans_without_nvcc(monkeypatch, tmp_path):
    """Nothing is built when the module is imported or planned; the first
    launch builds, and without nvcc it raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert "adamw" not in _build._loaded and not adamw._fns
    adamw.Workspace.of(_tensors())
    with pytest.raises(RuntimeError, match="nvcc"):
        adamw._lib()
    assert not adamw._fns


@pytest.fixture(scope="module")
def chip_smoke():
    repo = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, repo)
    try:
        yield importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(repo)


@pytest.mark.parametrize("kind, clip, tensors, want", [
    ("adamw", 1.0, 250, (4, 1, 4)), ("adam", 1.0, 64, (1, 1, 1)), ("adam", None, 65, (0, 0, 2)),
    ("sgd", 1.0, 16, (0, 0, 0)),
])
def test_chip_smoke_derives_the_launches_of_an_update(chip_smoke, kind, clip, tensors, want):
    """The card's smoke run holds every training path's fused AdamW launches
    to `adamw_updates`: an adamw_update a run of at most MAX_TENSORS
    non-empty tensors, as many adamw_sumsq and one adamw_norm with the clip;
    none for SGD or a swapped norm."""
    tx = optim.build_optimizer({"type": kind, "lr": 1e-3}, None, gradient_clip_val=clip)
    params = [torch.zeros(3)] * tensors + [torch.zeros(0)]
    got = chip_smoke.adamw_updates((tx, params))
    assert tuple(got[k] for k in ("adamw_sumsq", "adamw_norm", "adamw_update")) == want
    if kind != "sgd":
        assert len(adamw.Workspace.of(params).groups) == want[2]
        swapped = dataclasses.replace(tx, norm=lambda ts: optim.global_norm(ts))
        assert not any(chip_smoke.adamw_updates((swapped, params)).values())


def test_chip_smoke_derives_a_trainers_launches_from_its_config(chip_smoke):
    """`adamw_of_config` of the quick GAN experiment: the generator's update
    and the discriminator's, as the Trainer's step runs them."""
    cfg = chip_smoke.compose(chip_smoke.cli_train.default_config_dir(), "config", chip_smoke.GAN_QUICK_OVERRIDES)
    g = chip_smoke.build_model(dict(cfg["model"]), "bf16", "meta", train=True)
    d = chip_smoke.build_discriminator(cfg["training"]["discriminator"], "cpu", seed=0)
    runs = [len(adamw.Workspace.of([p for p in m.parameters() if p.requires_grad]).groups) for m in (g, d)]
    assert chip_smoke.adamw_of_config(cfg) == {"adamw_sumsq": sum(runs), "adamw_norm": 2, "adamw_update": sum(runs)}
