#!/usr/bin/env python
"""Generate the PyTorch port's interactive notebooks, the twins of
scripts/build_notebooks.py's: notebooks/vanilla_vae_interactive_torch.ipynb
and notebooks/conditional_disentangled_vae_interactive_torch.ipynb.

They have the JAX notebooks' cells, on the port (`medvae_tpu_torch`):
every cell runs headless end to end (tiny sizes while MEDVAE_NB_QUICK=1,
the default), on the card unless MEDVAE_NB_DEVICE=cpu. Figures are PNGs
written by the port's utils/visualization.py into ./nb_figures_torch/,
which needs no matplotlib, and are shown through IPython.display where it
imports. The widget cells skip to a static figure where ipywidgets is
missing.

Run `python scripts/build_notebooks_torch.py [--out DIR]` to (re)generate
them. The notebooks are written with `json` alone (no nbformat needed).
Generated notebooks are committed; this script is the reviewable source.
`run_notebook(path)` executes a notebook's code cells in order in one
namespace, as a headless kernel would.
"""

from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "notebooks")
NAMES = ("vanilla_vae_interactive_torch.ipynb", "conditional_disentangled_vae_interactive_torch.ipynb")

SETUP = '''\
# Setup: headless-safe; the card by default (MEDVAE_NB_DEVICE=cpu for the CPU)
import os, sys
sys.path.insert(0, os.path.abspath(".."))  # repo root when run from notebooks/
sys.path.insert(0, os.path.abspath("."))

import numpy as np
import torch

from medvae_tpu_torch.utils import visualization as viz

DEVICE = torch.device(os.environ.get("MEDVAE_NB_DEVICE", "cuda"))
if DEVICE.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("MEDVAE_NB_DEVICE=cuda and there is no CUDA device; set MEDVAE_NB_DEVICE=cpu")
QUICK = bool(int(os.environ.get("MEDVAE_NB_QUICK", "1")))  # tiny sizes by default
EPOCH_BATCHES = 10 if QUICK else 200
FIGS = os.path.abspath("nb_figures_torch")
os.makedirs(FIGS, exist_ok=True)


def show(path):
    """Display a written PNG where IPython's display imports."""
    try:
        from IPython.display import Image, display
    except ImportError:
        print(f"figure: {path}")
        return
    display(Image(filename=path))


name = torch.cuda.get_device_name(0) if DEVICE.type == "cuda" else "cpu"
print(f"device: {DEVICE} ({name})  quick={QUICK}")
'''


def _md(text: str) -> dict:
    return {"cell_type": "markdown", "metadata": {}, "source": text}


def _code(text: str) -> dict:
    return {"cell_type": "code", "execution_count": None, "metadata": {}, "outputs": [], "source": text}


def _vanilla_cells():
    return [
        _md(
            "# Vanilla VAE — interactive walkthrough (PyTorch port)\n\n"
            "The port's twin of `vanilla_vae_interactive.ipynb`: train a small "
            "`BaseVAE` on ChestMNIST (synthetic fallback when no npz is "
            "present), inspect reconstructions, prior samples, latent "
            "interpolations and a 2-D latent projection, then explore the "
            "latent space with sliders (widget cell is optional)."
        ),
        _code(SETUP),
        _code(
            '''\
# Data + model
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.data import DeviceFeeder, MedMNISTDataModule
from medvae_tpu_torch.train import build_optimizer, build_train_step, create_train_state
from medvae_tpu_torch.utils import count_parameters

dm = MedMNISTDataModule(dataset_names=["chestmnist"], batch_size=64, size=28,
                        root="./data", synthetic_fallback=True,
                        augment_train=False)
dm.setup("fit")

model = build_model(dict(_target_="medvae_tpu.models.BaseVAE", input_channels=1, latent_dim=8,
                         hidden_channels=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                         dropout=0.0, resolution=28), "fp32", DEVICE, train=True)
init_weights(model, seed=0)
print(f"{count_parameters(model):,} params")
'''
        ),
        _code(
            '''\
# Short training run (the production train step)
tx = build_optimizer({"type": "adam", "lr": 2e-3}, None)
state = create_train_state(model, tx)
step = build_train_step(model, {"type": "vae"}, tx, augment=False, max_channels=1)
feeder = DeviceFeeder(dm.train_arrays, 64, DEVICE, shuffle=True)
gen = torch.Generator(DEVICE).manual_seed(7)
losses = []
for epoch in range(1 if QUICK else 3):
    for i, batch in enumerate(feeder.epoch(epoch)):
        if i >= EPOCH_BATCHES:
            break
        state, m = step(state, batch, gen)
        losses.append(float(m["train/loss"]))
print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
'''
        ),
        _md("## Reconstructions"),
        _code(
            '''\
from medvae_tpu_torch.data.pipeline import preprocess

model.eval()
val_feeder = DeviceFeeder(dm.val_arrays, 64, DEVICE, shuffle=False, drop_last=False)
batch = next(iter(val_feeder.epoch(0)))
with torch.no_grad():
    x = preprocess(batch, augment=False, max_channels=1)
    out = model(x, generator=torch.Generator(DEVICE).manual_seed(0))
x, recon, z = (t.float().cpu().numpy() for t in (x, out["reconstruction"], out["z"]))
viz.plot_reconstructions(x, recon, os.path.join(FIGS, "vanilla_reconstructions.png"))
show(os.path.join(FIGS, "vanilla_reconstructions.png"))
'''
        ),
        _md("## Prior samples"),
        _code(
            '''\
with torch.no_grad():
    samples = model.sample(16, torch.Generator(DEVICE).manual_seed(3)).float().cpu().numpy()
viz.plot_samples(samples, os.path.join(FIGS, "vanilla_prior_samples.png"), grid=(2, 8))
show(os.path.join(FIGS, "vanilla_prior_samples.png"))
'''
        ),
        _md("## Latent interpolation"),
        _code(
            '''\
za, zb = z[0], z[1]
steps = 8
grid = np.stack([za * (1 - t) + zb * t for t in np.linspace(0, 1, steps)])
with torch.no_grad():
    decoded = model.decode(torch.from_numpy(grid.astype(np.float32)).to(DEVICE)).float().cpu().numpy()
viz.save_image_grid(decoded, os.path.join(FIGS, "vanilla_interpolation.png"), cols=steps)
show(os.path.join(FIGS, "vanilla_interpolation.png"))
'''
        ),
        _md("## 2-D latent projection"),
        _code(
            '''\
zf = z.reshape(len(z), -1)
zc = zf - zf.mean(0)
# PCA via SVD (no sklearn dependency needed here)
_, _, vt = np.linalg.svd(zc, full_matrices=False)
p2 = zc @ vt[:2].T
labels = batch["label"].cpu().numpy()
viz.scatter_plot(p2, labels, os.path.join(FIGS, "vanilla_latent_pca.png"))
show(os.path.join(FIGS, "vanilla_latent_pca.png"))
'''
        ),
        _md(
            "## Interactive explorer (optional)\n\n"
            "Sliders over the first latent dimensions; requires `ipywidgets` "
            "in a live kernel — the cell degrades to a static decode "
            "headless."
        ),
        _code(
            '''\
r = model.encoder_out_res

def decode_point(**dims):
    zvec = np.zeros((1, r, r, model.latent_dim), np.float32)
    for name, v in dims.items():
        zvec[..., int(name[1:])] = v
    with torch.no_grad():
        img = model.decode(torch.from_numpy(zvec).to(DEVICE)).float().cpu().numpy()
    path = os.path.join(FIGS, "vanilla_decode_point.png")
    viz.save_image(img[0], path)
    show(path)

try:
    import ipywidgets as widgets
    from IPython.display import display
    sliders = {f"z{i}": widgets.FloatSlider(min=-3, max=3, step=0.1, value=0.0,
                                            description=f"z{i}")
               for i in range(min(4, model.latent_dim))}
    out = widgets.interactive_output(decode_point, sliders)
    display(widgets.VBox(list(sliders.values())), out)
except ImportError as e:
    print(f"(no live widget frontend: {type(e).__name__}) static decode:")
    decode_point(z0=1.5, z1=-1.0)
'''
        ),
    ]


def _disentangled_cells():
    return [
        _md(
            "# Disentangled conditional VAE — interactive walkthrough (PyTorch port)\n\n"
            "The port's twin of `conditional_disentangled_vae_interactive.ipynb`: "
            "train the flagship `DisentangledConditionalVAE` on a 5-modality "
            "mix, reconstruct mixed batches, generate per-modality samples, "
            "probe disentanglement by swapping `z_modality`, and measure "
            "modality separation. Widget cell optional."
        ),
        _code(SETUP),
        _code(
            '''\
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.data import DeviceFeeder, MedMNISTDataModule
from medvae_tpu_torch.train import build_optimizer, build_train_step, create_train_state
from medvae_tpu_torch.utils import count_parameters

MODS = ["chestmnist", "octmnist", "pathmnist", "dermamnist", "pneumoniamnist"]
dm = MedMNISTDataModule(dataset_names=MODS, batch_size=64, size=28,
                        root="./data", synthetic_fallback=True,
                        augment_train=False)
dm.setup("fit")

model = build_model(dict(_target_="medvae_tpu.models.DisentangledConditionalVAE", num_modalities=5,
                         shared_latent_dim=8, modality_latent_dim=8, hidden_channels=16, ch_mult=(1, 2),
                         num_res_blocks=1, attn_resolutions=(), resolution=28), "fp32", DEVICE, train=True)
init_weights(model, seed=0)
print(f"{count_parameters(model):,} params")
'''
        ),
        _code(
            '''\
tx = build_optimizer({"type": "adam", "lr": 2e-3}, None)
state = create_train_state(model, tx)
loss_cfg = {"type": "disentangled_vae", "separation_weight": 0.1,
            "contrastive_weight": 0.05}
step = build_train_step(model, loss_cfg, tx, augment=False, max_channels=3)
feeder = DeviceFeeder(dm.train_arrays, 64, DEVICE, shuffle=True)
gen = torch.Generator(DEVICE).manual_seed(7)
losses, seps = [], []
for epoch in range(1 if QUICK else 3):
    for i, batch in enumerate(feeder.epoch(epoch)):
        if i >= EPOCH_BATCHES:
            break
        state, m = step(state, batch, gen)
        losses.append(float(m["train/loss"]))
        seps.append(float(m["train/separation_loss"]))
print(f"train/loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
      f"separation loss (lower = further apart) {seps[0]:.4f} -> {seps[-1]:.4f}")
'''
        ),
        _md("## Mixed-modality reconstructions"),
        _code(
            '''\
from medvae_tpu_torch.data.medmnist import CHANNELS_BY_MODALITY_INDEX
from medvae_tpu_torch.data.pipeline import preprocess

model.eval()
# shuffle so one batch mixes all 5 modalities (the split concatenates
# datasets in order, so an unshuffled batch would be single-modality)
val_feeder = DeviceFeeder(dm.val_arrays, 64, DEVICE, shuffle=True, drop_last=False)
batch = next(iter(val_feeder.epoch(0)))
with torch.no_grad():
    x = preprocess(batch, augment=False, max_channels=3)
    out = model(x, batch["modality_idx"].long(), generator=torch.Generator(DEVICE).manual_seed(0))
x, recon, z = (t.float().cpu().numpy() for t in (x, out["reconstruction"], out["z"]))
midx = batch["modality_idx"].cpu().numpy()

def show_img(img, mod):
    # grayscale modalities live in channel 0; RGB use all three
    c = int(CHANNELS_BY_MODALITY_INDEX[mod])
    return np.repeat(img[..., :1], 3, axis=-1) if c == 1 else img

viz.plot_reconstructions(np.stack([show_img(x[i], midx[i]) for i in range(8)]),
                         np.stack([show_img(recon[i], midx[i]) for i in range(8)]),
                         os.path.join(FIGS, "disentangled_reconstructions.png"))
show(os.path.join(FIGS, "disentangled_reconstructions.png"))
print("modalities:", midx[:8].tolist())
'''
        ),
        _md("## Per-modality conditional samples"),
        _code(
            '''\
rows = []
with torch.no_grad():
    for mod in range(5):
        midx_s = torch.full((6,), mod, dtype=torch.long, device=DEVICE)
        imgs = model.sample_conditional(6, midx_s, torch.Generator(DEVICE).manual_seed(10 + mod))
        rows.append(np.stack([show_img(im, mod) for im in imgs.float().cpu().numpy()]))
viz.save_image_grid(np.concatenate(rows), os.path.join(FIGS, "disentangled_samples.png"), cols=6)
show(os.path.join(FIGS, "disentangled_samples.png"))
print("rows:", MODS)
'''
        ),
        _md(
            "## Disentanglement probe: swap `z_modality`\n\n"
            "Keep `z_shared` from an image of modality A, replace the "
            "modality partition with one encoded from modality B, decode "
            "with B's head — content should persist, style should switch."
        ),
        _code(
            '''\
mods_here = np.unique(midx)
ia = int(np.nonzero(midx == mods_here[0])[0][0])   # first modality present
ib = int(np.nonzero(midx == mods_here[-1])[0][0])  # a different one
mod_a, mod_b = int(midx[ia]), int(midx[ib])
za, zb = z[ia:ia + 1], z[ib:ib + 1]
sd = model.shared_latent_dim
z_swap = np.concatenate([za[..., :sd], zb[..., sd:]], axis=-1)

def dec(zz, mod):
    with torch.no_grad():
        return model.decode(torch.from_numpy(zz).to(DEVICE),
                            torch.tensor([mod], device=DEVICE)).float().cpu().numpy()

panels = [show_img(x[ia], mod_a), show_img(x[ib], mod_b), show_img(dec(z_swap, mod_b)[0], mod_b)]
viz.save_image_grid(np.stack(panels), os.path.join(FIGS, "disentangled_swap.png"), cols=3)
show(os.path.join(FIGS, "disentangled_swap.png"))
print(f"A ({MODS[mod_a]}), B ({MODS[mod_b]}), A-content + B-style")
'''
        ),
        _md("## Modality separation statistics"),
        _code(
            '''\
zf = z.reshape(len(z), -1)
zm = zf[:, -model.modality_latent_dim * model.encoder_out_res ** 2:]
cents = np.stack([zm[midx == m].mean(0) for m in range(5) if (midx == m).any()])
d = np.sqrt(((cents[:, None] - cents[None]) ** 2).sum(-1))
print("pairwise centroid distances (z_modality):")
print(np.round(d, 2))
print(f"mean off-diagonal distance: {d[np.triu_indices(len(d), 1)].mean():.2f}"
      " (memo target: > 10 after full training)")
'''
        ),
        _md("## Interactive generator (optional)"),
        _code(
            '''\
def gen_samples(modality=0, seed=0, n=6):
    midx_s = torch.full((n,), int(modality), dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        imgs = model.sample_conditional(n, midx_s, torch.Generator(DEVICE).manual_seed(int(seed)))
    path = os.path.join(FIGS, "disentangled_generated.png")
    viz.save_image_grid(imgs.float().cpu().numpy(), path, cols=n)
    show(path)
    print(f"{MODS[int(modality)]} (seed {seed})")

try:
    import ipywidgets as widgets
    from IPython.display import display
    w_mod = widgets.Dropdown(options=[(n, i) for i, n in enumerate(MODS)],
                             description="modality")
    w_seed = widgets.IntSlider(min=0, max=20, description="seed")
    out = widgets.interactive_output(gen_samples, {"modality": w_mod, "seed": w_seed})
    display(widgets.HBox([w_mod, w_seed]), out)
except ImportError as e:
    print(f"(no live widget frontend: {type(e).__name__}) static generation:")
    gen_samples(modality=2, seed=3)
'''
        ),
    ]


def _lines(text: str) -> list:
    return text.splitlines(keepends=True)


def notebook(cells) -> dict:
    """nbformat 4.5 JSON: sources as line lists, ids by position."""
    for i, cell in enumerate(cells):
        cell["id"] = f"cell-{i:02d}"
        cell["source"] = _lines(cell["source"])
    return {
        "cells": cells,
        "metadata": {"kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
                     "language_info": {"name": "python"}},
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def build(out_dir: str = OUT) -> list:
    """Write both notebooks into `out_dir`; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, cells in zip(NAMES, (_vanilla_cells(), _disentangled_cells())):
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(notebook(cells), f, indent=1, ensure_ascii=False)
            f.write("\n")
        paths.append(path)
    return paths


def run_notebook(path: str) -> dict:
    """Execute the notebook's code cells in order in one namespace (the
    current directory is the kernel's); returns the namespace."""
    with open(path) as f:
        nb = json.load(f)
    namespace = {"__name__": "__main__"}
    for i, cell in enumerate(nb["cells"]):
        if cell["cell_type"] == "code":
            exec(compile("".join(cell["source"]), f"{os.path.basename(path)}[{i}]", "exec"), namespace)
    return namespace


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=OUT)
    for path in build(p.parse_args(argv).out):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
