"""The port's walkthroughs and notebooks on the CPU: both
`examples/*_walkthrough_torch.py` scripts train their shipped quick
experiment for one epoch of a few batches (`--limit_batches` for the
disentangled one, the config's limit for the vanilla one) and write every
figure; both `notebooks/*_torch.ipynb` run their code cells in order
(MEDVAE_NB_DEVICE=cpu, MEDVAE_NB_QUICK=1) and write theirs; the notebooks
regenerate from scripts/build_notebooks_torch.py to the committed files.
Each run is in this process, under two torch threads, in a temporary
working directory (the configs' work_dir is $PWD).
"""

import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch

from medvae_tpu_torch.utils.visualization import read_png_size

REPO = Path(__file__).resolve().parents[1]
VANILLA_FIGURES = ["interpolation.png", "latent_pca.png", "prior_samples.png", "reconstructions.png"]
DISENTANGLED_FIGURES = ["modality_swap.png", "reconstructions.png", "samples_chestmnist.png",
                        "samples_dermamnist.png", "samples_octmnist.png", "samples_pathmnist.png",
                        "samples_pneumoniamnist.png"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PWD", str(tmp_path))
    return tmp_path


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _notebooks():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return importlib.import_module("build_notebooks_torch")
    finally:
        sys.path.remove(str(REPO / "scripts"))


def _pngs(directory: Path, names) -> None:
    for name in names:
        width, height = read_png_size(str(directory / name))
        assert width > 0 and height > 0, name


def test_vanilla_walkthrough_runs_on_the_cpu(workdir, monkeypatch):
    """Its epoch cut to 4 of chest_base_vae_quick's 16 bs-128 steps (1.6 s
    a step on two threads here), which the script's flags cannot ask for."""
    from medvae_tpu_torch import config

    compose = config.compose
    monkeypatch.setattr(config, "compose", lambda *a, overrides=(), **k: compose(
        *a, overrides=[*overrides, "+training.limit_train_batches=4"], **k))
    walk = _load(REPO / "examples/vanilla_vae_walkthrough_torch.py")
    out = walk.main(["--device", "cpu", "--epochs", "1", "--out", str(workdir / "figs")])
    assert out["figures"] == VANILLA_FIGURES
    _pngs(workdir / "figs", VANILLA_FIGURES)
    assert math.isfinite(out["recon_mse"]) and out["recon_mse"] < 0.5


def test_disentangled_walkthrough_runs_on_the_cpu(workdir):
    walk = _load(REPO / "examples/disentangled_vae_walkthrough_torch.py")
    out = walk.main(["--device", "cpu", "--epochs", "1", "--limit_batches", "4", "--out", str(workdir / "figs")])
    assert out["figures"] == DISENTANGLED_FIGURES
    _pngs(workdir / "figs", DISENTANGLED_FIGURES)
    assert math.isfinite(out["centroid_distance"]) and out["centroid_distance"] > 0
    assert -1.0 <= out["silhouette"] <= 1.0


@pytest.mark.parametrize("script", ["vanilla_vae_walkthrough_torch.py", "disentangled_vae_walkthrough_torch.py"])
def test_walkthroughs_default_to_the_card(script, workdir):
    if torch.cuda.is_available():
        pytest.skip("this host has a card, so the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(REPO / "examples" / script).main(["--out", str(workdir / "figs")])


@pytest.mark.parametrize("index", [0, 1])
def test_notebook_runs_on_the_cpu(index, workdir, monkeypatch):
    nb = _notebooks()
    monkeypatch.setenv("MEDVAE_NB_DEVICE", "cpu")
    monkeypatch.setenv("MEDVAE_NB_QUICK", "1")
    namespace = nb.run_notebook(str(REPO / "notebooks" / nb.NAMES[index]))
    figures = sorted(p.name for p in (workdir / "nb_figures_torch").glob("*.png"))
    prefix = ("vanilla_", "disentangled_")[index]
    assert figures and all(f.startswith(prefix) for f in figures)
    _pngs(workdir / "nb_figures_torch", figures)
    assert namespace["losses"][-1] < namespace["losses"][0]
    assert all(math.isfinite(v) for v in namespace["losses"])


def test_notebooks_regenerate_to_the_committed_ones(tmp_path):
    nb = _notebooks()
    for path in nb.build(str(tmp_path)):
        name = Path(path).name
        assert Path(path).read_text() == (REPO / "notebooks" / name).read_text(), name
    assert sorted(p.name for p in (REPO / "notebooks").glob("*_torch.ipynb")) == sorted(nb.NAMES)
