"""The port's attention ops (medvae_tpu_torch/ops) against the JAX package.

The JAX flash kernel runs in Pallas interpret mode, as
tests/test_flash_attention.py runs it, with 32-row blocks so that n=96 takes
3x3 blocks and the online-softmax rescale is exercised. Inputs are made with
numpy from a seed and handed to both packages. The CUDA kernel itself builds
and runs only on the card: tests/test_torch_port_cuda.py and chip_smoke.py hold
it against flash_attention_plain there.
"""

import ast
import importlib
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvae_tpu.ops import attention as jattn
from medvae_tpu.ops import flash_attention as jfa
from medvae_tpu_torch.ops import _build
from medvae_tpu_torch.ops import attention as tattn
from medvae_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_MAX_BLOCK", 32)  # n=96 -> 3x3 blocks
    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(seed, b, n, c):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, n, c).astype(np.float32) for _ in range(3)]


def test_flash_plain_matches_jax_flash_kernel_fp32(interpret):
    q, k, v = _qkv(0, 2, 96, 128)
    want = np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v))))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_flash_plain_matches_jax_flash_kernel_bf16(interpret):
    q, k, v = _qkv(1, 2, 96, 128)
    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = tfa.flash_attention_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=4e-3)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("n", [96, 100])
def test_reference_attention_matches_jax(n):
    q, k, v = _qkv(2, 2, n, 64)
    want = np.asarray(jattn.reference_attention(*map(jnp.asarray, (q, k, v))))
    got = tattn.reference_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 40, 64))
    before = dict(tfa.launches)
    out = tfa.flash_attention(q, k, v)
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v))
    assert tfa.launches == before  # only kernel launches count


@pytest.mark.parametrize(
    "n, c, flash",
    [(3136, 512, True), (784, 1024, False), (49, 1024, False), (256, 32, False),
     (12544, 256, True), (3136, 500, False)],
)
def test_dispatch_gate_matches_tpu_routing(n, c, flash, monkeypatch):
    assert tattn.uses_flash(n, c) is flash
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v: calls.append("flash") or q)
    monkeypatch.setattr(tattn, "reference_attention", lambda q, k, v: calls.append("ref") or q)
    q = torch.empty((1, n, c), device="meta")
    tattn.attention(q, q, q)
    assert calls == ["flash" if flash else "ref"]


@pytest.mark.parametrize(
    "shape, dtype, match",
    [((2, 64, 100), torch.float32, "multiple of 64"),
     ((2, 64, 2048), torch.float32, "multiple of 64"),
     ((2, 64, 128), torch.float16, "bf16 or fp32"),
     ((64, 128), torch.float32, "one shape")],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, dtype, match):
    t = torch.zeros(shape, dtype=dtype)
    with pytest.raises((ValueError, TypeError), match=match):
        tfa._check(t, t, t)


def test_wrapper_rejects_non_contiguous():
    t = torch.zeros((2, 128, 64)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check(t, t, t)


def test_build_targets_hopper_into_a_hashed_ignored_path():
    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    target = _build._target("flash_fwd")
    assert target.parent == REPO / "build" / "medvae_tpu_torch"
    assert target.name.startswith("flash_fwd-") and target.suffix == ".so"
    assert "build/" in (REPO / ".gitignore").read_text().split()



def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh names a new library for every source, so no
    source is served from a stale build of a header it includes."""
    (tmp_path / "a.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("a")
    assert _build._target("a") == before
    (tmp_path / "hopper.cuh").write_text("// two\n")
    assert _build._target("a") != before
    assert {p.name for p in (REPO / "medvae_tpu_torch/ops/csrc").glob("*.cuh")} == {"hopper.cuh"}


@pytest.mark.parametrize("script, source", [("flash_fwd_variants", "flash_fwd.cu"),
                                            ("flash_bwd_variants", "flash_bwd.cu"),
                                            ("attention_variants", "attention.cu"),
                                            ("gn_variants", "groupnorm_swish.cu")])
def test_kernel_variants_still_apply_to_the_committed_sources(script, source, monkeypatch):
    """Every literal substitution of a variants script matches the source it
    edits, so each variant still builds from the committed tree."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    variants = importlib.import_module("_variants")
    table = importlib.import_module(script).VARIANTS
    original = (REPO / "medvae_tpu_torch/ops/csrc" / source).read_text()
    assert table["committed"] == []
    for name, subs in table.items():
        assert (variants.substitute(source, name, subs) != original) == bool(subs), name


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "orbax", "optax") or root == "medvae_tpu"


def _port_sources() -> list:
    """(name, python source) of every program of the port: the package,
    chip_smoke.py, the `_torch` walkthroughs and notebook builder, the
    code cells of the `_torch` notebooks and the python heredocs of the
    `_torch` shell scripts."""
    files = (sorted((REPO / "medvae_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "examples").glob("*_torch.py")) + [REPO / "scripts/build_notebooks_torch.py"])
    sources = [(str(f.relative_to(REPO)), f.read_text()) for f in files]
    for nb in sorted((REPO / "notebooks").glob("*_torch.ipynb")):
        cells = [c for c in json.loads(nb.read_text())["cells"] if c["cell_type"] == "code"]
        sources += [(f"notebooks/{nb.name}[{i}]", "".join(c["source"])) for i, c in enumerate(cells)]
    for sh in sorted((REPO / "scripts").glob("*_torch.sh")):
        for i, body in enumerate(re.findall(r"python - <<'(\w+)'\n(.*?)\n\1\n", sh.read_text(), re.S)):
            sources.append((f"scripts/{sh.name}[heredoc {i}]", body[1]))
    return sources


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10
    assert {"examples", "notebooks", "scripts"} <= {name.split("/")[0] for name, _ in sources}
    assert any("heredoc" in name for name, _ in sources)
    bad = []
    for name, source in sources:
        for node in ast.walk(ast.parse(source, filename=name)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    for sh in sorted((REPO / "scripts").glob("*_torch.sh")):
        modules = re.findall(r"python -m ([\w.]+)", sh.read_text())
        assert modules, sh.name
        bad += [f"scripts/{sh.name} -m {m}" for m in modules if _forbidden(m)]
    assert not bad, bad
