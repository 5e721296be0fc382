"""The port's span and counter store (medvae_tpu_torch/core/tracing.py) and
the spans at its layer boundaries, on the CPU: off by default, on while a
torch profiler records (on every thread), the batcher's queue and batch
spans, a train step's sections, the kernels' launch counters, and the
device spans' events."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medvae_tpu_torch import bench
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.nn.discriminator import build_discriminator
from medvae_tpu_torch.ops import attention, flash_attention, groupnorm_swish
from medvae_tpu_torch.serve import InferenceEngine, MicroBatcher
from medvae_tpu_torch.train.optim import build_optimizer, discriminator_optimizer
from medvae_tpu_torch.train.state import create_train_state
from medvae_tpu_torch.train.step import build_train_step, make_frozen

TINY = dict(input_channels=3, latent_dim=4, hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(), resolution=16)
GAN_LOSS = {"type": "lpips_discriminator", "discriminator_factor": 0.5, "perceptual_factor": 1.0,
            "pixel_factor": 1.0, "kl_factor": 1e-3, "discriminator_iter_start": 0}
OPT = ({"type": "adamw", "lr": 1e-4, "weight_decay": 1e-5, "betas": [0.5, 0.999]}, {"type": "constant"})


@pytest.fixture(autouse=True)
def clean_store():
    tracing.reset()
    tracing.enable(None)
    yield
    tracing.reset()
    tracing.enable(None)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [s for s in spans if s[4] == parent]


def test_nothing_recorded_by_default():
    assert not tracing.active()
    null = tracing.span("a")
    assert null is tracing.span("b") is tracing.device_span("c")  # one shared null context
    with tracing.span("a") as sid, tracing.device_span("c"):
        tracing.section("d")
        assert sid is None
    assert tracing.record("e", 0, 1) is None
    assert tracing.spans() == []
    tracing.enable(True)
    with tracing.span("a", req=3) as sid:
        pass
    (only,) = tracing.spans()
    assert only[0] == sid and only[1] == "a" and only[3] >= only[2] and only[5] == {"req": 3}
    tracing.enable(False)
    with _cpu_profile():
        with tracing.span("a"):
            pass
    assert len(tracing.spans()) == 1  # False holds even under a profiler


def test_spans_record_under_a_profiler_on_every_thread_and_stop_with_it():
    go, done = threading.Event(), threading.Event()

    def worker():  # started before the profile: a thread-local flag would read False here
        go.wait(timeout=10)
        with tracing.span("worker"):
            pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with _cpu_profile():
        assert tracing.active()
        with tracing.span("main"):
            pass
        go.set()
        assert done.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    assert sorted(s[1] for s in tracing.spans()) == ["main", "worker"]
    assert not tracing.active()
    with tracing.span("after"):
        pass
    assert len(tracing.spans()) == 2


def test_nesting_sections_records_and_export(tmp_path):
    tracing.enable(True)
    with tracing.span("outer") as outer:
        with tracing.device_span("step") as step:  # a plain span on the CPU
            tracing.section("s1")
            tracing.section("s1")  # the same name continues the open section
            tracing.section("s2")
        queued = tracing.record("wait", 5, 9, parent=outer, req=1)
    tracing.section("orphan")  # no span open: no section
    spans = {s[1]: s for s in tracing.spans()}
    assert set(spans) == {"outer", "step", "s1", "s2", "wait"}
    assert spans["step"][4] == outer and spans["s1"][4] == step and spans["s2"][4] == step
    assert spans["s1"][3] <= spans["s2"][2] <= spans["s2"][3] <= spans["step"][3]
    assert spans["wait"][:5] == (queued, "wait", 5, 9, outer)
    assert tracing.device_ms("step") == {}  # no events on the CPU
    out = json.loads(open(tracing.export(str(tmp_path / "spans.json"))).read())
    assert {s["name"] for s in out["spans"]} == set(spans) and out["clock"] == "time.perf_counter_ns"
    assert "launches.flash_fwd" in out["counters"]


def test_span_store_is_capped_and_counts_the_overflow(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.enable(True)
    for _ in range(5):
        with tracing.span("x"):
            pass
    assert len(tracing.spans()) == 3 and tracing.counters()["tracing.dropped"] == 2


def test_counters_hold_the_kernels_launches():
    mods = (attention, flash_attention, groupnorm_swish)
    saved = [dict(m.launches) for m in mods]
    try:
        for i, m in enumerate(mods):
            with m._count_lock:
                for j, name in enumerate(m.launches):
                    m.launches[name] += 10 * i + j + 1
        tracing.count("alloc.retries", 2)
        snap = tracing.counters()
        for m in mods:
            for name, n in m.launches.items():
                assert snap[f"launches.{name}"] == n
        assert snap["alloc.retries"] == 2
        tracing.reset()  # the store's own counters go, the kernels' stay theirs
        assert "alloc.retries" not in tracing.counters()
        assert tracing.counters()["launches.flash_fwd"] == flash_attention.launches["flash_fwd"]
    finally:
        for m, before in zip(mods, saved):
            with m._count_lock:
                m.launches.update(before)


def test_batcher_spans_one_queue_span_a_request_under_the_batch_that_took_it():
    model = init_weights(build_model(dict(TINY, _target_="ConditionalVAE"), "fp32", "cpu", train=False), 0)
    engine = InferenceEngine(model, buckets=(1, 4), device="cpu")
    sizes = []
    inner = engine.reconstruct

    def counted(images, modality=None, output="float32"):
        sizes.append(len(images))
        return inner(images, modality=modality, output=output)

    engine.reconstruct = counted
    engine.reconstruct(np.zeros((1, 16, 16, 3), np.uint8))  # warm-up, unrecorded
    sizes.clear()
    batcher = MicroBatcher(engine, max_batch=4, max_delay_ms=20.0)
    images = np.random.RandomState(0).randint(0, 255, (10, 16, 16, 3), np.uint8)
    try:
        with _cpu_profile():
            futs = []
            for i in range(10):
                futs.append(batcher.submit(images[i], modality=i % 5))
                if i % 3 == 2:
                    time.sleep(0.03)
            for f in futs:
                f.result(timeout=60)
    finally:
        batcher.close()
    spans = tracing.spans()
    queue = [s for s in spans if s[1] == "batcher.queue"]
    batches = sorted((s for s in spans if s[1] == "batcher.batch"), key=lambda s: s[5]["batch"])
    assert sorted(s[5]["req"] for s in queue) == list(range(10))
    assert all(s[3] >= s[2] for s in queue)
    by_id = {s[0]: s for s in batches}
    assert all(s[4] in by_id for s in queue)
    assert [len([q for q in queue if q[4] == b[0]]) for b in batches] == sizes
    assert sum(sizes) == 10 and len(sizes) >= 3
    for b in batches:  # each engine call's copy and launch inside its batch
        assert [s[1] for s in _children(spans, b[0]) if s[1].startswith("engine.")] == ["engine.h2d",
                                                                                     "engine.launch"]


def _tiny_step(gan: bool):
    model = init_weights(build_model(dict(TINY, _target_="ConditionalVAE"), "fp32", "cpu", train=True), 0)
    loss = GAN_LOSS if gan else {"type": "vae"}
    tx = build_optimizer(*OPT)
    disc = disc_tx = None
    if gan:
        disc = build_discriminator({"input_nc": 3, "ndf": 8, "n_layers": 2}, "cpu", seed=0)
        disc_tx = discriminator_optimizer(*OPT)
    state = create_train_state(model, tx, make_frozen(loss, "cpu"), disc=disc, disc_tx=disc_tx)
    step = build_train_step(model, loss, tx, disc=disc, disc_tx=disc_tx)
    return step, state, bench.synthetic_batch(2, 16, "cpu")


@pytest.mark.parametrize("gan, sections", [
    (True, ["step.g_forward", "step.adaptive_weight", "step.g_backward", "step.disc", "step.optimizer"]),
    (False, ["step.forward", "step.backward", "step.optimizer"]),
], ids=["gan", "plain"])
def test_train_step_sections_in_stream_order_under_step(gan, sections):
    step, state, batch = _tiny_step(gan)
    with _cpu_profile():
        state, _ = step(state, batch, torch.Generator().manual_seed(0))
    spans = tracing.spans()
    (outer,) = [s for s in spans if s[1] == "step"]
    inner = sorted(_children(spans, outer[0]), key=lambda s: s[2])
    assert [s[1] for s in inner] == sections
    assert all(a[3] <= b[2] for a, b in zip(inner, inner[1:]))
    assert outer[2] <= inner[0][2] and inner[-1][3] <= outer[3]
    assert "alloc.retries" not in tracing.counters()  # read on the card only


def test_feeder_gathers_and_pins_each_batch():
    from medvae_tpu_torch.data.pipeline import DeviceFeeder

    arrays = bench.synthetic_split(12, 16)
    feeder = DeviceFeeder(arrays, 4, "cpu", shuffle=False, drop_last=True)
    with _cpu_profile():
        batches = list(feeder.epoch(0))
    names = [s[1] for s in tracing.spans()]
    assert len(batches) == 3 and names.count("feed.gather") == 3 and names.count("feed.pin") == 3


class _Event:
    """A stand-in for torch.cuda.Event on the CPU: 2 ms between its pair,
    complete once `done`."""

    done = True

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns()

    def query(self):
        return _Event.done

    def elapsed_time(self, end):
        assert end.query(), "elapsed_time on an event still in flight"
        return 2.0


def test_device_spans_keep_events_only_when_kept_and_skip_those_in_flight(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(tracing, "_on_device", lambda: True)
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    monkeypatch.setattr(_Event, "done", True)
    tracing.enable(True)
    for _ in range(4):
        with tracing.device_span("engine.launch"):
            pass
    assert len(tracing.spans()) == 2 and tracing.counters()["tracing.dropped"] == 2
    assert len(tracing._events) == 2  # the dropped spans keep no events
    assert list(tracing.device_ms("engine.launch").values()) == [2.0, 2.0]
    _Event.done = False  # a reader while the last work is still in flight
    assert tracing.device_ms("engine.launch") == {}
    with open(tracing.export(str(tmp_path / "spans.json"))) as f:
        assert [s["name"] for s in json.load(f)["spans"] if "device_ms" not in s] == ["engine.launch"] * 2
