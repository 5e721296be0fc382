"""The port's public surface: every name of each JAX subpackage's `__all__`
is importable from the port's counterpart, but for the JAX-only names
below, each with its reason; each subpackage imports alone in a fresh
interpreter without JAX or the JAX package; `instantiate` resolves
registered, reference and dotted `medvae_tpu.*` targets to the port's
classes without importing the JAX package; `pyproject.toml` ships every
file the port builds from.
"""

import ast
import importlib
import subprocess
import sys
import tomllib
from fnmatch import fnmatch
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SUBPACKAGES = sorted(p.parent.name for p in (REPO / "medvae_tpu").glob("*/__init__.py"))

# JAX-only names: each is a JAX placement object or a pytree placement the
# port has no counterpart of, and the counterpart it has instead.
JAX_ONLY = {
    ("core", "data_sharding"): "a jax NamedSharding of a global batch; torch has no global array, "
                               "the port places each rank's rows by rank (core/mesh.py: Mesh.local_rows)",
    ("core", "replicated_sharding"): "a jax NamedSharding of replicated params; the port replicates "
                                     "by broadcast (core/mesh.py: replicate)",
    ("parallel", "shard_params"): "jax.device_put of a param pytree under the TP rules; the port shards "
                                  "modules (parallel/tensor_parallel.py: shard_model)",
    ("parallel", "shard_state"): "jax.device_put of a train-state pytree; the port's state holds the "
                                 "module's own (sharded) tensors (parallel/tensor_parallel.py: shard_model)",
}


def _jax_all(sub: str) -> list:
    """`__all__` of medvae_tpu/<sub>/__init__.py, read without importing it."""
    tree = ast.parse((REPO / "medvae_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "__all__":
            return [e.value for e in node.value.elts]
    return []


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_has_its_counterpart(sub):
    port = importlib.import_module(f"medvae_tpu_torch.{sub}")
    missing = [n for n in _jax_all(sub) if (sub, n) not in JAX_ONLY and not hasattr(port, n)]
    assert not missing, f"medvae_tpu_torch.{sub} lacks {missing}"


def test_the_jax_only_names_are_jax_exports_the_port_lacks():
    for sub, name in JAX_ONLY:
        assert name in _jax_all(sub)
        assert not hasattr(importlib.import_module(f"medvae_tpu_torch.{sub}"), name)


def test_root_package_names_its_version_and_imports_config():
    import medvae_tpu_torch

    assert medvae_tpu_torch.__version__ == "0.1.0"
    assert medvae_tpu_torch.config.register_target is not None


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("sub", ["", *SUBPACKAGES, "cli.train", "entry"])
def test_subpackage_imports_alone_without_jax(sub):
    name = f"medvae_tpu_torch.{sub}" if sub else "medvae_tpu_torch"
    out = _fresh(f"import sys, {name} as m\n"
                 "names = getattr(m, '__all__', [])\n"
                 "[getattr(m, n) for n in names]\n"
                 "print(sorted(k for k in sys.modules if k.split('.')[0] in "
                 "('jax', 'jaxlib', 'flax', 'medvae_tpu')))")
    assert out.strip() == "[]"


def test_instantiate_resolves_to_the_port_without_the_jax_package():
    out = _fresh("""
import sys
from medvae_tpu_torch import config, models, nn
from medvae_tpu_torch.data import MedMNISTDataModule

config.register_target("my.Thing", lambda **kw: ("built", kw))
assert config.instantiate({"_target_": "my.Thing", "a": 1}) == ("built", {"a": 1})
disc = config.instantiate({"_target_": "src.models.NLayerDiscriminator", "input_nc": 1, "ndf": 8})
assert type(disc) is nn.NLayerDiscriminator and disc.conv0.in_channels == 1
dec = config.instantiate({"_target_": "medvae_tpu.nn.Decoder", "ch": 8, "out_ch": 1, "num_res_blocks": 1,
                          "attn_resolutions": [], "resolution": 16, "z_channels": 4, "ch_mult": [1, 2],
                          "tanh_out": True})
assert type(dec) is nn.Decoder and dec.tanh_out
vae = config.instantiate({"_target_": "medvae_tpu.models.BaseVAE", "input_channels": 1, "latent_dim": 4,
                          "hidden_channels": 8, "ch_mult": [1, 2], "num_res_blocks": 1,
                          "attn_resolutions": [], "resolution": 16})
assert type(vae) is models.BaseVAE
dm = config.instantiate({"_target_": "src.data.MedMNISTDataModule", "dataset_names": ["chestmnist"]})
assert type(dm) is MedMNISTDataModule
block = config.instantiate({"_target_": "medvae_tpu_torch.nn.ResnetBlock", "in_channels": 8,
                            "out_channels": 16, "conv_shortcut": True})
assert block.conv_shortcut.kernel_size == (3, 3) and block.nin_shortcut is None
try:
    config.instantiate({"_target_": "medvae_tpu.nn.NoSuchBlock"})
except NotImplementedError as e:
    assert "medvae_tpu.nn.NoSuchBlock" in str(e)
else:
    raise AssertionError("a rewritten target with no counterpart must raise")
print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'medvae_tpu')))
""")
    assert out.strip().splitlines()[-1] == "[]"


def test_package_data_ships_every_file_the_port_builds_from():
    """Every file `ops/_build.py` and `native/__init__.py` read from the
    package matches a pattern of pyproject's package-data."""
    patterns = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"][
        "medvae_tpu_torch"]
    pkg = REPO / "medvae_tpu_torch"
    read = [*(pkg / "ops" / "csrc").glob("*.cu"), *(pkg / "ops" / "csrc").glob("*.cuh"),
            *(pkg / "native").glob("*.cpp")]
    assert {p.suffix for p in read} == {".cu", ".cuh", ".cpp"}
    unshipped = [str(p.relative_to(pkg)) for p in read
                 if not any(fnmatch(str(p.relative_to(pkg)), pat) for pat in patterns)]
    assert not unshipped, unshipped
    from medvae_tpu_torch import native
    from medvae_tpu_torch.ops import _build

    assert native._SRC.parent == pkg / "native" and _build.CSRC == pkg / "ops" / "csrc"
