"""The 16-channel KL-f8 autoencoder of Stable Diffusion 3 / FLUX.1
(`config/models.py:KL_F8_C16`) on the CPU: its parameter count, the port's
BaseVAE and the benchmark's frozen BaseVAE against the published
AutoencoderKL in plain PyTorch (portbench/reference/autoencoder_kl.py, torch
alone) at a small cut of the same pattern with weights mapped through the
diffusers importer (compat/diffusers_import.py), the importer's map and
refusals, B6/B7's batch slices past 2^31 elements, and the route
counters of the attention and GroupNorm+SiLU gates."""

import importlib.util
from pathlib import Path

import pytest
import torch

from medvae_tpu_torch.compat.diffusers_import import convert_diffusers_state_dict, diffusers_name
from medvae_tpu_torch.config.models import KL_F8_C16, build_model
from medvae_tpu_torch.core import tracing
from medvae_tpu_torch.ops import groupnorm_swish as gs
from medvae_tpu_torch.ops.attention import attention

ROOT = Path(__file__).resolve().parents[1]
# the cut: every published kind of layer and the 1-2-4-4 pattern, at hidden
# 32 and 64² (the mid-block attention over 8² tokens)
CUT = dict(KL_F8_C16, hidden_channels=32, resolution=64)
CUT_REF = dict(block_out_channels=(32, 64, 128, 128), sample_size=64)


def _published():
    spec = importlib.util.spec_from_file_location("autoencoder_kl", ROOT / "portbench/reference/autoencoder_kl.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@torch.no_grad()
def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every param drawn from `seed`: kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.1²), biases N(0, 0.1²), so a key mapped to the wrong tensor
    shows."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        z = torch.randn(p.shape, generator=gen)
        if p.dim() > 1:
            p.copy_(z * p[0].numel() ** -0.5)
        else:
            p.copy_(z * 0.1 + (1.0 if "norm" in name and name.endswith("weight") else 0.0))
    return module


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def cut_models():
    """(published AutoencoderKL at the cut with seeded weights, the port's
    fp32 BaseVAE with them through the importer, an NCHW batch, noise)."""
    ref = _seeded(_published().AutoencoderKL(**CUT_REF), 7).eval()
    port = build_model(CUT, "fp32", "cpu", train=False)
    port.load_state_dict(convert_diffusers_state_dict(ref.state_dict(), port))
    gen = torch.Generator().manual_seed(11)
    x = torch.rand((2, 3, 64, 64), generator=gen) * 2 - 1
    noise = torch.randn((2, 16, 8, 8), generator=gen)
    return ref, port, x, noise


def test_preset_is_the_published_autoencoder_at_full_width():
    """83.82 M params, and its keys map one to one onto the published
    AutoencoderKL's with the same shapes (both built on the meta device)."""
    port = build_model(KL_F8_C16, "fp32", "meta", train=True)
    with torch.device("meta"):
        ref = _published().AutoencoderKL()
    assert sum(p.numel() for p in port.parameters()) == sum(p.numel() for p in ref.parameters()) == 83_819_683
    mapped = {diffusers_name(k, 4): tuple(v.shape) for k, v in port.state_dict().items()}
    published = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert set(mapped) == set(published)
    for k, shape in mapped.items():
        assert shape == published[k] or shape == published[k] + (1, 1), k
    assert port.encoder.mid.attn_1.q.weight.shape == (512, 512, 1, 1)
    assert not any(len(level.attn) for level in port.encoder.down)


@pytest.mark.parametrize("what", ["mean", "logvar", "reconstruct", "forward"])
def test_port_agrees_with_the_published_autoencoder(cut_models, what):
    """The port's BaseVAE in fp32 against the published AutoencoderKL with
    the same weights, to 1e-5 relative L2 (the port's NHWC against the
    reference's NCHW)."""
    ref, port, x, noise = cut_models
    nhwc = x.permute(0, 2, 3, 1)
    with torch.no_grad():
        r_mean, r_logvar = ref.encode(x)
        mean, logvar = port.encode(nhwc)
        got, want = {
            "mean": (mean, r_mean),
            "logvar": (logvar, r_logvar),
            "reconstruct": (port.decode(mean), ref.reconstruct(x)),
            "forward": (port(nhwc, noise=noise.permute(0, 2, 3, 1))["reconstruction"], ref(x, noise)),
        }[what]
    assert (r_logvar > -30).all() and (r_logvar < 20).all()  # the published clamp is not reached
    assert _rel(got.permute(0, 3, 1, 2), want) <= 1e-5


def test_frozen_reference_agrees_with_the_published_autoencoder(cut_models):
    """The benchmark's frozen BaseVAE (portbench/reference/, the port's
    layout) with the port's weights: its encode and reconstruct agree with
    the published AutoencoderKL's."""
    from portbench.reference import model as ref_model

    ref, port, x, _ = cut_models
    frozen = ref_model.build(CUT, "cpu", train=False)
    frozen.load_state_dict(port.state_dict())
    with torch.no_grad():
        mean, logvar = frozen.encode(x.permute(0, 2, 3, 1))
        r_mean, r_logvar = ref.encode(x)
        rec = frozen.decode(mean)
        want = ref.reconstruct(x)
    assert _rel(mean.permute(0, 3, 1, 2), r_mean) <= 1e-5
    assert _rel(logvar.permute(0, 3, 1, 2), r_logvar) <= 1e-5
    assert _rel(rec.permute(0, 3, 1, 2), want) <= 1e-5


def test_importer_maps_every_tensor_and_refuses_a_partial_map(cut_models):
    """Every port tensor is its published counterpart (a 1x1 conv for a
    Linear), bit for bit; an unknown key, a missing key, a shape that
    differs and attention inside a level (no diffusers counterpart) raise."""
    ref, port, _, _ = cut_models
    published = ref.state_dict()
    for key, value in port.state_dict().items():
        want = published[diffusers_name(key, 4)]
        assert torch.equal(value, want.reshape(value.shape)), key
    assert diffusers_name("decoder.up.3.block.0.conv1.weight", 4) == "decoder.up_blocks.0.resnets.0.conv1.weight"
    assert diffusers_name("encoder.down.1.block.0.nin_shortcut.weight", 4) == \
        "encoder.down_blocks.1.resnets.0.conv_shortcut.weight"
    assert diffusers_name("decoder.mid.attn_1.proj_out.bias", 4) == "decoder.mid_block.attentions.0.to_out.0.bias"
    with pytest.raises(KeyError, match="unknown"):
        convert_diffusers_state_dict({**published, "quant_conv.weight": torch.zeros(32, 32, 1, 1)}, port)
    with pytest.raises(KeyError, match="missing"):
        convert_diffusers_state_dict({k: v for k, v in published.items() if "to_k" not in k}, port)
    with pytest.raises(ValueError, match="shape"):
        convert_diffusers_state_dict({**published, "encoder.conv_in.bias": torch.zeros(31)}, port)
    with pytest.raises(KeyError):
        convert_diffusers_state_dict(published, build_model(dict(CUT, attn_resolutions=[8]), "fp32", "meta"))


@pytest.mark.parametrize("shape, elem, want", [
    ((24, 2048, 56, 56), 2, [(0, 24)]),  # gan224's largest: one slice, as before
    ((8, 128, 1024, 1024), 2, [(0, 8)]),  # 2^30 elements
    ((8, 256, 1024, 1024), 2, [(0, 4), (4, 8)]),  # exactly 2^31: the 1024² decoder's first block
    ((9, 256, 1024, 1024), 4, [(0, 5), (5, 9)]),
    ((17, 256, 1024, 1024), 2, [(0, 6), (6, 12), (12, 17)]),
    ((1, 2048, 1024, 1024), 2, None),  # one image of 2^31 elements
    ((2**24, 3, 7, 7), 2, None),  # an image of 294 bytes: a slice would start off 16-byte alignment
])
def test_batch_slices_cover_the_batch_in_launches_under_2_31(shape, elem, want):
    slices = gs.batch_slices(shape, elem)
    assert slices == want
    if slices is None:
        return
    per_image = shape[1] * shape[2] * shape[3]
    assert slices[0][0] == 0 and slices[-1][1] == shape[0]
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all((hi - lo) * per_image < 2**31 for lo, hi in slices)
    assert len(slices) == -(-shape[0] * per_image // (2**31 - 1)) or len(slices) == 1


@pytest.fixture
def store():
    tracing.reset()
    yield tracing
    tracing.reset()
    tracing.enable(None)


@pytest.mark.parametrize("n, c, route", [(16384, 512, "flash"), (256, 64, "fused"), (64, 32, "plain")])
def test_attention_counts_its_route_once_a_call_only_while_tracing(store, monkeypatch, n, c, route):
    """`attn.<route>` by the gate's route; the kernels' wrappers are
    stubbed, so the 16,384-token shape costs nothing on the CPU."""
    import medvae_tpu_torch.ops.attention as attn

    for name in ("attention_fwd", "flash_attention", "reference_attention"):
        monkeypatch.setattr(attn, name, lambda q, k, v: q)
    q = torch.zeros((1, n, c), device="meta")
    attention(q, q, q)
    assert not any(k.startswith("attn.") for k in store.counters())
    store.enable(True)
    attention(q, q, q)
    attention(q, q, q)
    assert {k: v for k, v in store.counters().items() if k.startswith("attn.")} == {f"attn.{route}": 2}


@pytest.mark.parametrize("shape, sliced", [((8, 256, 1024, 1024), 1), ((8, 128, 1024, 1024), 0)])
def test_gate_counts_sliced_site_calls_only_while_tracing(store, monkeypatch, shape, sliced):
    """`gn.sliced` counts a fused site call whose batch B6 takes in more
    than one launch, beside `gn.fused`; a meta tensor stands for the card's
    (B6's wrapper stubbed)."""
    monkeypatch.setattr(gs, "fused_route", lambda *a, **k: True)
    monkeypatch.setattr(gs, "group_norm_swish_fwd", lambda x, *a: (x, None, None))
    x = torch.zeros(shape, dtype=torch.bfloat16, device="meta")
    w = torch.ones((shape[1],), device="meta")
    with torch.no_grad():
        gs.fused_group_norm_swish_or_none(x, w, w, 32, 1e-6)
        assert store.counters().get("gn.sliced") is None
        store.enable(True)
        gs.fused_group_norm_swish_or_none(x, w, w, 32, 1e-6)
    counts = store.counters()
    assert counts.get("gn.fused") == 1 and counts.get("gn.sliced", 0) == sliced


def test_card_route_takes_the_1024_decoder_shape():
    """The gate's card route: the (8, 256, 1024, 1024) site (2^31 elements)
    is fused in slices; an image of 2^31 elements is left plain."""
    assert gs.fused_route(None, "cuda", torch.bfloat16, (8, 256, 1024, 1024), 32)
    assert gs.fused_route(None, "cuda", torch.float32, (8, 256, 1024, 1024), 32)
    assert not gs.fused_route(None, "cuda", torch.bfloat16, (1, 2048, 1024, 1024), 32)
