"""Reference Lightning checkpoints into the port (compat/torch_import.py,
cli/import_ckpt.py) against the JAX package's importer, on the CPU.

A reference-named Lightning state dict is made in-process for a small
BaseVAE, concat ConditionalVAE, DisentangledConditionalVAE and a
linear-attention trunk: random values from a numpy seed in torch layouts,
`model.`-prefixed, the flagship's decoder heads split into per-modality
`modality_decoders.{m}.{0,2}` and its projectors as 1x1 convs, beside keys
an importer skips (loss towers, the discriminator, the unused
`modality_embedding`). The same dict goes through
`medvae_tpu.compat.torch_import.convert_state_dict` and the port's: the
reports must be identical and the two converted models must encode and
decode alike within fp32 2e-4. The reference's own models, which
tests/test_torch_import.py reads from a checkout of the reference, are not
needed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.compat import torch_import as jimport
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu_torch.cli import import_ckpt
from medvae_tpu_torch.cli.common import load_checkpoint, load_model
from medvae_tpu_torch.compat import convert_state_dict
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.serve import InferenceEngine

TOL = 2e-4
TRUNK = dict(hidden_channels=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
             dropout=0.0, resolution=16)
CASES = {
    "base": (JaxBaseVAE, dict(TRUNK, input_channels=3, latent_dim=4)),
    "concat_cvae": (JaxCVAE, dict(TRUNK, input_channels=3, latent_dim=4, condition_dim=5)),
    "flagship": (JaxDCVAE, dict(TRUNK, num_modalities=5, shared_latent_dim=2, modality_latent_dim=2)),
    "linear_attention": (JaxBaseVAE, dict(TRUNK, input_channels=3, latent_dim=4, use_linear_attn=True)),
}
SKIPPED = {"loss.perceptual_loss.net.lin0.weight": (1, 4, 1, 1),
           "discriminator.main.0.weight": (8, 3, 4, 4),
           "model.criterion.logvar": (1,)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _random(rs, name, shape):
    if len(shape) >= 2:
        return rs.randn(*shape).astype(np.float32) * float(np.prod(shape[1:])) ** -0.5
    base = 1.0 if "norm" in name and name.endswith("weight") else 0.0
    return (base + 0.1 * rs.randn(*shape)).astype(np.float32)


def lightning_state_dict(model, seed):
    """{name: torch tensor} as the reference's VAELightningModule saves it for
    `model`'s architecture, random values, plus keys an importer skips."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, t in model.state_dict().items():
        v = _random(rs, name, tuple(t.shape))
        if name.startswith(("heads_conv1.", "heads_conv2.")):
            seq = "0" if name.startswith("heads_conv1") else "2"
            for m, part in enumerate(np.split(v, model.num_modalities, axis=0)):
                out[f"model.modality_decoders.{m}.{seq}.{name.split('.')[-1]}"] = part
            continue
        if name.startswith(("in_proj_", "out_proj_")):
            stem, leaf, m = name.rsplit("_", 2)
            group = "modality_input_projectors" if stem == "in_proj" else "modality_output_projectors"
            if leaf == "kernel":
                v = v.T[:, :, None, None]  # (in, out) -> 1x1 conv (out, in, 1, 1)
            out[f"model.{group}.{m}.{'weight' if leaf == 'kernel' else 'bias'}"] = v
            continue
        if name.startswith("condition_proj."):
            name = name.replace("condition_proj.", "condition_proj.0.")
        out[f"model.{name}"] = v
    if hasattr(model, "num_modalities"):
        out["model.modality_embedding.weight"] = _random(rs, "e", (model.num_modalities, 8))
    for name, shape in SKIPPED.items():
        out[name] = _random(rs, name, shape)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _jax_params(cls, kw):
    jm = cls(**kw)
    args = [jnp.zeros((2, 16, 16, 3))] + ([jnp.zeros((2,), jnp.int32)] if cls is JaxDCVAE else
                                          [jnp.zeros((2, 5))] if cls is JaxCVAE else [])
    return jm, jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                *args)["params"]


def _cond(cls, midx):
    if cls is JaxDCVAE:
        return [midx.astype(np.int32)]
    return [np.eye(5, dtype=np.float32)[midx]] if cls is JaxCVAE else []


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_the_jax_importer(case):
    cls, kw = CASES[case]
    tm = build_model(dict(kw, _target_=cls.__name__), "fp32", "cpu")
    ckpt = lightning_state_dict(tm, seed=len(case))
    jm, jparams = _jax_params(cls, kw)
    jconverted, jreport = jimport.convert_state_dict({k: v.numpy() for k, v in ckpt.items()}, jparams)
    converted, report = convert_state_dict(ckpt, tm)
    assert report == jreport
    assert set(report["skipped"]) >= set(SKIPPED)
    assert len(report["mapped"]) + len(report["skipped"]) == len(ckpt)
    tm.load_state_dict(converted)

    rs = np.random.RandomState(7)
    x = rs.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    cond = _cond(cls, np.arange(5))
    jmu, jlv = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=jm.encode))(
        jconverted, jnp.asarray(x), *map(jnp.asarray, cond))
    with torch.no_grad():
        tmu, tlv = tm.encode(torch.from_numpy(x), *map(torch.from_numpy, cond))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=TOL)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), atol=TOL)
    route = [jnp.arange(5)] if cls is JaxDCVAE else []
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=jm.decode))(jconverted, jmu, *route)
    with torch.no_grad():
        got = tm.decode(tmu, *(torch.arange(5) for _ in route))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_flagship_heads_and_projectors_are_assembled_as_the_model_stores_them():
    cls, kw = CASES["flagship"]
    tm = build_model(dict(kw, _target_=cls.__name__), "fp32", "cpu")
    ckpt = lightning_state_dict(tm, seed=3)
    converted, report = convert_state_dict(ckpt, tm)
    c = tm.max_channels
    for m in range(5):
        for seq, conv in (("0", "heads_conv1"), ("2", "heads_conv2")):
            torch.testing.assert_close(converted[f"{conv}.weight"][m * c:(m + 1) * c],
                                       ckpt[f"model.modality_decoders.{m}.{seq}.weight"], rtol=0, atol=0)
    # modalities 0 and 3 have one channel: (3, 1, 1, 1) conv -> (1, 3) matrix
    torch.testing.assert_close(converted["in_proj_kernel_0"],
                               ckpt["model.modality_input_projectors.0.weight"][:, :, 0, 0].T, rtol=0, atol=0)
    assert converted["out_proj_kernel_3"].shape == (3, 1)
    assert "model.modality_embedding.weight" in report["skipped"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_unmatched_keys_and_shapes_raise_as_in_jax(package):
    cls, kw = CASES["base"]
    tm = build_model(dict(kw, _target_=cls.__name__), "fp32", "cpu")
    ckpt = lightning_state_dict(tm, seed=5)
    if package == "jax":
        _, jparams = _jax_params(cls, kw)

        def convert(sd):
            return jimport.convert_state_dict({k: v.numpy() for k, v in sd.items()}, jparams)
    else:
        def convert(sd):
            return convert_state_dict(sd, tm)
    extra = dict(ckpt, **{"model.encoder.down.0.block.0.bogus.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="has no parameter in the target model"):
        convert(extra)
    wrong = dict(ckpt, **{"model.encoder.conv_in.weight": torch.zeros(16, 2, 3, 3)})
    with pytest.raises(ValueError, match="shape mismatch for model.encoder.conv_in.weight"):
        convert(wrong)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A Lightning .ckpt of the quick flagship cut to 16² through the CLI."""
    tmp = tmp_path_factory.mktemp("import")
    overrides = ["precision=fp32", "model.hidden_channels=16", "model.ch_mult=[1,2]",
                 "model.num_res_blocks=1", "model.attn_resolutions=[16]", "model.resolution=16",
                 "model.shared_latent_dim=2", "model.modality_latent_dim=2", "model.dropout=0.0",
                 "data.size=16"]
    cls, kw = CASES["flagship"]
    source = build_model(dict(kw, _target_=cls.__name__), "fp32", "cpu")
    ckpt = lightning_state_dict(source, seed=11)
    path = tmp / "epoch=7.ckpt"
    torch.save({"state_dict": ckpt, "epoch": 7, "global_step": 123,
                "hyper_parameters": {"model": {"hidden_channels": 16}}}, path)
    rc = import_ckpt.main(["--ckpt", str(path), "--experiment", "disentangled_multi_modal_cvae_quick",
                           "--output_dir", str(tmp / "run")]
                          + [a for o in overrides for a in ("--override", o)])
    assert rc == 0
    converted, _ = convert_state_dict(ckpt, source)
    source.load_state_dict(converted)
    return str(tmp / "run" / "imported"), source


def test_cli_round_trip_into_load_model_and_the_engine(imported):
    ckpt_dir, source = imported
    assert os.path.isfile(os.path.join(os.path.dirname(ckpt_dir), "config.yaml"))
    saved = load_checkpoint(ckpt_dir)
    assert saved["precision"] == "fp32" and saved["model"]["hidden_channels"] == 16
    model = load_model(ckpt_dir, device="cpu")
    for name, t in source.state_dict().items():
        assert torch.equal(model.state_dict()[name], t), name
    engine = InferenceEngine.from_checkpoint(ckpt_dir, buckets=(1, 4), device="cpu")
    rs = np.random.RandomState(3)
    images = rs.randint(0, 256, (5, 16, 16, 3), np.uint8)
    mods = np.array([0, 1, 2, 3, 4], np.int32)
    with torch.no_grad():
        x = torch.from_numpy(images).float() / 255.0 * 2.0 - 1.0
        mean, _ = source.encode(x, torch.from_numpy(mods))
        want = source.decode(mean, torch.from_numpy(mods)).float().numpy()
    np.testing.assert_allclose(engine.reconstruct(images, modality=mods), want, atol=1e-6)


def test_import_then_serve_needs_the_card_unless_asked_for_the_cpu(imported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine.from_checkpoint(imported[0])
