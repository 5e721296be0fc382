"""The port's serving surface (medvae_tpu_torch/serve, cli) against the JAX engine.

A tiny DisentangledConditionalVAE is initialised by the JAX package and loaded
into the port; both engines get the same uint8 requests. The port engine runs
on device="cpu" here, which it does only when asked.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.serve import InferenceEngine as JaxEngine
from medvae_tpu_torch.cli.common import save_checkpoint
from medvae_tpu_torch.cli.serve import _b64_to_np, _np_to_b64, serve
from medvae_tpu_torch.compat.jax_params import from_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.serve import InferenceEngine, MicroBatcher, to_uint8

TINY = dict(
    num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, hidden_channels=8,
    ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=16,
)
CFG = dict(TINY, _target_="DisentangledConditionalVAE")
TOL = 2e-4


@pytest.fixture(scope="module")
def engines():
    jm = JaxDCVAE(**TINY)
    variables = jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm = build_model(CFG, "fp32", "cpu")
    state = from_jax_params(params, tm)
    tm.load_state_dict(state)
    port = InferenceEngine(tm, buckets=(2, 4), device="cpu")
    return JaxEngine(jm, params, buckets=(2, 4)), port, state


def _images(seed, n):
    return np.random.RandomState(seed).randint(0, 256, (n, 16, 16, 3), np.uint8)


def test_reconstruct_encode_decode_match_jax_engine(engines):
    jeng, port, _ = engines
    x = _images(0, 5)  # 4 + 1 padded to 2
    midx = np.array([0, 1, 2, 3, 4], np.int32)
    assert list(port._chunks(5)) == list(jeng._chunks(5)) == [(0, 4, 4), (4, 1, 2)]
    got = port.reconstruct(x, modality=midx)
    assert got.shape == (5, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jeng.reconstruct(x, modality=midx), atol=TOL)
    mean, logvar = port.encode(x, modality=midx)
    jmean, jlogvar = jeng.encode(x, modality=midx)
    np.testing.assert_allclose(mean, jmean, atol=TOL)
    np.testing.assert_allclose(logvar, jlogvar, atol=TOL)
    np.testing.assert_allclose(
        port.decode(jmean, modality=midx), jeng.decode(jmean, modality=midx), atol=TOL
    )


def test_uint8_output_and_modality_forms_match_jax_engine(engines):
    jeng, port, _ = engines
    x = _images(1, 3)
    got = port.reconstruct(x, modality="pathmnist", output="uint8")
    assert got.dtype == np.uint8
    want = jeng.reconstruct(x, modality="pathmnist", output="uint8")
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1  # rounding ties
    np.testing.assert_array_equal(
        port.reconstruct(x, modality=np.array([1], np.int32)),
        port.reconstruct(x, modality="pathmnist"),
    )
    np.testing.assert_array_equal(to_uint8(np.array([-1.0, 0.0, 1.0, 2.0])), [0, 128, 255, 255])


@pytest.mark.parametrize("modality", [np.array([0, 5], np.int32), np.array([-1, 0], np.int32)])
def test_modality_out_of_range_is_rejected_like_jax(engines, modality):
    jeng, port, _ = engines
    x = _images(2, 2)
    with pytest.raises(ValueError, match="out of range"):
        port.reconstruct(x, modality=modality)
    with pytest.raises(ValueError, match="out of range"):
        jeng.reconstruct(x, modality=modality)


def test_engine_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(build_model(CFG, "fp32", "cpu"))
    assert InferenceEngine(build_model(CFG, "fp32", "cpu"), device="cpu").device.type == "cpu"


def test_sample_is_seeded_and_shaped(engines):
    _, port, _ = engines
    a = port.sample(3, modality="octmnist", seed=7)
    assert a.shape == (3, 16, 16, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, port.sample(3, modality="octmnist", seed=7))
    assert np.abs(a - port.sample(3, modality="octmnist", seed=8)).max() > 1e-6


def test_warmup_info_and_checkpoint_roundtrip(engines, tmp_path):
    _, port, state = engines
    assert port.warmup() == 8
    info = port.info()
    assert info["model"] == "DisentangledConditionalVAE" and info["latent_dim"] == 8
    assert info["buckets"] == [2, 4] and len(info["modalities"]) == 5
    path = str(tmp_path / "model.pt")
    save_checkpoint(path, state, CFG, "fp32")
    loaded = InferenceEngine.from_checkpoint(path, buckets=(2, 4), device="cpu")
    x = _images(3, 2)
    np.testing.assert_array_equal(loaded.reconstruct(x), port.reconstruct(x))


def test_microbatcher_coalesces_and_matches_engine(engines):
    _, port, _ = engines
    mb = MicroBatcher(port, max_batch=4, max_delay_ms=30.0)
    try:
        imgs = _images(4, 4)
        futs = [mb.submit(imgs[i], modality=i % 5) for i in range(4)]
        got = np.stack([f.result(timeout=30) for f in futs])
        want = port.reconstruct(imgs, modality=np.arange(4, dtype=np.int32))
        np.testing.assert_allclose(got, want, atol=1e-6)
    finally:
        mb.close()


def test_http_round_trip(engines):
    _, port, _ = engines
    httpd = serve(port, host="127.0.0.1", port=0, warmup=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.load(r)

    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        imgs = _images(5, 3)
        out = _b64_to_np(post("/reconstruct", {"images_b64": _np_to_b64(imgs),
                                               "modality": [0, 1, 2]})["images_b64"])
        np.testing.assert_allclose(
            out, port.reconstruct(imgs, modality=np.array([0, 1, 2], np.int32)), atol=1e-6
        )
        mean = _b64_to_np(post("/encode", {"images_b64": _np_to_b64(imgs)})["mean_b64"])
        assert mean.shape == (3, 8, 8, 8)
        smp = _b64_to_np(post("/sample", {"num_samples": 2, "modality": 1, "seed": 5})["images_b64"])
        assert smp.shape == (2, 16, 16, 3)
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/reconstruct", {})
        assert err.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
