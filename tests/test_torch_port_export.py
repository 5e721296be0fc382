"""torch.export artifacts of the port (serve/export.py) and the three
serving ops they hold (`medvae::flash_attention`, `medvae::attention_fwd`,
`medvae::gn_swish_fwd`), on the CPU.

Small models of the three families (hidden 32, ch_mult (1, 2), one res
block, attention at 16², 16² inputs, fp32) are initialised by the JAX
package and loaded into the port with `from_jax_params`. Each is exported by
both packages at batch 4 from the same weights and run on the same uint8
images, modality indices and noise: outputs within 2e-4. Each family's
export routes one kind of site to an op, as the card's shapes do at full
width (the gates monkeypatched as tests/test_torch_port_ops.py does): the
flagship's attention to B1's op, the BaseVAE's to B4's, the
ConditionalVAE's GroupNorm+SiLU to B6's with MEDVAE_FUSED_GN=1. On the CPU
each op runs its plain version, so the artifact equals the port's engine
bit for bit.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.serve import export as jexport
from medvae_tpu_torch.compat.jax_params import from_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.nn.blocks import AttnBlock, ResnetBlock
from medvae_tpu_torch.nn.encoder_decoder import Decoder, Encoder
from medvae_tpu_torch.ops import attention as at
from medvae_tpu_torch.ops import flash_attention as fa
from medvae_tpu_torch.ops import groupnorm_swish as gs
from medvae_tpu_torch.serve import InferenceEngine, export_model, load_exported
from medvae_tpu_torch.serve.engine import sample_batch
from medvae_tpu_torch.serve.export import medvae_ops

TOL = 2e-4
B = 4
TRUNK = dict(hidden_channels=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=16)
# family -> (JAX class, config, the gate sent to the op, MEDVAE_FUSED_GN, the op)
FAMILIES = {
    "DisentangledConditionalVAE": (JaxDCVAE, dict(TRUNK, num_modalities=5, shared_latent_dim=2,
                                                  modality_latent_dim=2), "uses_flash", "0",
                                   "medvae.flash_attention"),
    "BaseVAE": (JaxBaseVAE, dict(TRUNK, input_channels=3, latent_dim=4), "uses_fused", "0",
                "medvae.attention_fwd"),
    "ConditionalVAE": (JaxCVAE, dict(TRUNK, input_channels=3, latent_dim=4), None, "1",
                       "medvae.gn_swish_fwd"),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _sites(module, op: str) -> int:
    """Sites of `op` one forward of `module` runs: an attention block each,
    or two GroupNorm+SiLU a res block and each codec's norm_out."""
    mods = list(module.modules())
    if op == "medvae.gn_swish_fwd":
        return 2 * sum(isinstance(m, ResnetBlock) for m in mods) + sum(
            isinstance(m, (Encoder, Decoder)) for m in mods)
    return sum(isinstance(m, AttnBlock) for m in mods)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def exported(request, tmp_path_factory):
    name = request.param
    cls, kw, gate, switch, op = FAMILIES[name]
    jm = cls(**kw)
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (B, 16, 16, 3), np.uint8)
    midx = np.array([0, 4, 1, 3], np.int32)
    noise = rs.randn(B, 8, 8, 4).astype(np.float32)
    args = [jnp.zeros((2, 16, 16, 3))] + ([jnp.zeros((2,), jnp.int32)] if cls is JaxDCVAE else
                                          [jnp.zeros((2, 12))] if cls is JaxCVAE else [])
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              *args)["params"]
    jdir = tmp_path_factory.mktemp("jax")
    jexport.export_model(jm, params, str(jdir), batch_size=B)
    jart = jexport.load_exported(str(jdir))
    want = {"reconstruct": jart["reconstruct"](images, midx), "sample": jart["sample"](noise, midx)}

    model = build_model(dict(kw, _target_=name), "fp32", "cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params), model))
    out = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MEDVAE_FUSED_GN", switch)
        if gate:
            mp.setattr(at, gate, lambda n, c: True)
        meta = export_model(model, str(out), batch_size=B)
        engine = InferenceEngine(model, buckets=(B,), device="cpu")
        eager = {"reconstruct": engine.reconstruct(images, modality=midx)}
        with torch.inference_mode():
            eager["sample"] = sample_batch(model, B, torch.from_numpy(midx),
                                           noise=torch.from_numpy(noise)).numpy()
    art = load_exported(str(out), device="cpu")
    got = {"reconstruct": art["reconstruct"](images, midx), "sample": art["sample"](noise, midx)}
    return dict(name=name, model=model, op=op, meta=meta, art=art, out=out, got=got, want=want,
                eager=eager)


def test_artifact_matches_the_jax_export(exported):
    for graph in ("reconstruct", "sample"):
        got, want = exported["got"][graph], exported["want"][graph]
        assert got.shape == want.shape == (B, 16, 16, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=graph)


def test_artifact_equals_the_engine_bit_for_bit(exported):
    for graph in ("reconstruct", "sample"):
        np.testing.assert_array_equal(exported["got"][graph], exported["eager"][graph], err_msg=graph)


def test_graphs_hold_the_ops_where_the_shapes_route_to_them(exported):
    model, op, meta = exported["model"], exported["op"], exported["meta"]
    want = {"reconstruct": {op: _sites(model, op)}, "sample": {op: _sites(model.decoder, op)}}
    assert want["reconstruct"][op] > want["sample"][op] > 0
    assert meta["ops"] == want
    for graph, program in exported["art"]["programs"].items():
        assert medvae_ops(program) == want[graph], graph
    assert meta == json.loads((exported["out"] / "meta.json").read_text())
    assert meta["fused_gn"] == (op == "medvae.gn_swish_fwd") and meta["device"] == "cpu"
    assert meta["batch_size"] == B and meta["latent_shape"] == [8, 8, 4]
    assert meta["model"] == exported["name"] and meta["input_channels"] == 3


def test_each_artifact_holds_only_the_weights_its_graph_reads(exported):
    programs = exported["art"]["programs"]
    for graph, program in programs.items():
        params = program.graph_signature.inputs_to_parameters
        unread = [params[n.name] for n in program.graph.nodes if n.name in params and not n.users]
        assert not unread, (graph, unread)
    sample, full = set(programs["sample"].state_dict), set(programs["reconstruct"].state_dict)
    assert sample < full and not any(k.startswith("model.encoder.") for k in sample)


def test_plain_routes_leave_no_op_in_the_graph(tmp_path):
    """At these shapes the unpatched gates send every site to the plain path."""
    _, kw, *_ = FAMILIES["BaseVAE"]
    model = build_model(dict(kw, _target_="BaseVAE"), "fp32", "cpu")
    meta = export_model(model, str(tmp_path), batch_size=2, sample_batch_size=3)
    assert meta["ops"] == {"reconstruct": {}, "sample": {}}
    assert (meta["batch_size"], meta["sample_batch_size"]) == (2, 3)
    sample = load_exported(str(tmp_path), device="cpu")["sample"]
    assert sample(np.zeros((3, 8, 8, 4), np.float32), np.zeros(3, np.int32)).shape == (3, 16, 16, 3)


def test_load_needs_the_card_unless_asked_for_the_cpu(exported, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported(str(exported["out"]))
    moved = tmp_path / "art"
    shutil.copytree(exported["out"], moved)
    meta = json.loads((moved / "meta.json").read_text())
    (moved / "meta.json").write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported on cuda"):
        load_exported(str(moved), device="cpu")


def test_export_takes_a_serving_model_only(tmp_path):
    _, kw, *_ = FAMILIES["BaseVAE"]
    with pytest.raises(ValueError, match="serving model"):
        export_model(build_model(dict(kw, _target_="BaseVAE"), "fp32", "cpu", train=True), str(tmp_path))


def _op_args(name):
    gen = torch.Generator().manual_seed(3)
    if name == "gn_swish_fwd":
        x = torch.randn((2, 64, 5, 7), generator=gen)
        return (x, torch.rand(64, generator=gen) + 0.5, torch.randn(64, generator=gen), 32, 1e-6)
    return tuple(torch.randn((2, 96, 64), generator=gen) for _ in range(3))


OPS = {"flash_attention": (fa.flash_attention, fa.flash_attention_plain),
       "attention_fwd": (at.attention_fwd, at.fused_attention_fwd_plain),
       "gn_swish_fwd": (gs.gn_swish_fwd, gs.group_norm_swish_plain)}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_passes_opcheck(name):
    op, _ = OPS[name]
    assert str(op._opoverload) == f"medvae.{name}.default"
    args = _op_args(name)
    torch.library.opcheck(op, args)
    # any layout in (a graph may replay other strides than it traced), a
    # contiguous output
    x = args[0].to(memory_format=torch.channels_last) if args[0].dim() == 4 else args[0].mT.contiguous().mT
    torch.library.opcheck(op, (x, *args[1:]))
    assert op(x, *args[1:]).is_contiguous()


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_on_the_cpu_is_its_plain_version_and_launches_nothing(name):
    op, plain = OPS[name]
    before = {**fa.launches, **at.launches, **gs.launches}
    args = _op_args(name)
    assert torch.equal(op(*args), plain(*args))
    low = (args[0].bfloat16(), *args[1:]) if name == "gn_swish_fwd" else tuple(a.bfloat16() for a in args)
    assert torch.equal(op(*low), plain(*low))
    assert {**fa.launches, **at.launches, **gs.launches} == before
