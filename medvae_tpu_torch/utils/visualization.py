"""Host-side image grids and figures (counterpart of
medvae_tpu/utils/visualization.py).

Images arrive as NHWC arrays in [−1, 1] or [0, 1]. The grids
(`save_image_grid`, `save_image`, `plot_reconstructions`, `plot_samples`)
are numpy canvases written by this module's own PNG encoder (stdlib zlib and
struct: 8-bit RGB, filter 0), so the Trainer's media and the CLIs' grids need
no imaging or plotting package. The pixel rule is the JAX package's,
`(canvas * 255).astype(np.uint8)`, which truncates. `plot_reconstructions`
and `plot_samples` draw the JAX figures' panels in the same order, without
their titles and axes. `plot_latent_space` and `plot_loss_curves` keep
matplotlib (and sklearn for t-SNE), imported when called.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def to_unit(images: np.ndarray, from_range: str = "auto") -> np.ndarray:
    """Rescale to [0,1] for display (reference rescales (x+1)/2)."""
    images = np.asarray(images, np.float32)
    if from_range == "auto":
        from_range = "[-1,1]" if images.min() < -0.01 else "[0,1]"
    if from_range == "[-1,1]":
        images = (images + 1.0) / 2.0
    return np.clip(images, 0.0, 1.0)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(rgb: np.ndarray, path: str) -> None:
    """An (h, w, 3) uint8 array as an 8-bit RGB PNG, every row filter 0."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes (h, w, 3) uint8, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def _rgb(img: np.ndarray) -> np.ndarray:
    return np.repeat(img, 3, axis=-1) if img.shape[-1] == 1 else img[..., :3]


def make_grid(
    images: np.ndarray, pad: int = 2, cols: "int | None" = None, rows: "int | None" = None
) -> np.ndarray:
    """Tile NHWC images (rescaled by `to_unit` as one array) row-major on a
    white canvas with `pad` pixels between and around them; `cols` columns,
    near-square by default, and `rows` rows, as many as the images fill by
    default. Returns the uint8 (h, w, 3) canvas."""
    imgs = to_unit(images)
    n, h, w, _ = imgs.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = rows or int(np.ceil(n / cols))
    canvas = np.ones((rows * (h + pad) + pad, cols * (w + pad) + pad, 3), np.float32)
    for i in range(n):
        y0 = pad + (i // cols) * (h + pad)
        x0 = pad + (i % cols) * (w + pad)
        canvas[y0:y0 + h, x0:x0 + w] = _rgb(imgs[i])
    return (canvas * 255).astype(np.uint8)


def save_image_grid(
    images: np.ndarray, path: str, pad: int = 2, cols: "int | None" = None
) -> None:
    """Tile images into one PNG (torchvision.make_grid equivalent).

    `cols` fixes the number of columns (e.g. one interpolation path per row);
    default is a near-square layout."""
    write_png(make_grid(images, pad, cols), path)


def save_image(image: np.ndarray, path: str) -> None:
    write_png((_rgb(to_unit(image)) * 255).astype(np.uint8), path)


def _per_image_unit(images: np.ndarray) -> np.ndarray:
    """Each image rescaled on its own, as the JAX figures' panels are."""
    return np.stack([to_unit(img) for img in images])


def plot_reconstructions(
    originals: np.ndarray,
    reconstructions: np.ndarray,
    save_path: Optional[str] = None,
    num_samples: int = 8,
) -> np.ndarray:
    """The first `num_samples` originals in the top row over their
    reconstructions; writes `save_path` when given and returns the canvas."""
    n = min(num_samples, len(originals))
    panels = np.concatenate([_per_image_unit(originals[:n]), _per_image_unit(reconstructions[:n])])
    grid = make_grid(panels, cols=n)
    if save_path:
        write_png(grid, save_path)
    return grid


def plot_samples(
    samples: np.ndarray,
    save_path: Optional[str] = None,
    grid: Optional[tuple] = None,
    title: str = "Samples",
) -> np.ndarray:
    """Samples row-major on a near-square grid (`grid` = (rows, cols) to fix
    it; panels past the samples stay blank). `title` is accepted for the JAX
    signature and not drawn."""
    del title
    n = len(samples)
    if grid is None:
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    else:
        rows, cols = grid
    canvas = make_grid(_per_image_unit(samples[: rows * cols]), cols=cols, rows=rows)
    if save_path:
        write_png(canvas, save_path)
    return canvas


def plot_latent_space(
    latents: np.ndarray,
    labels: np.ndarray,
    save_path: Optional[str] = None,
    method: str = "tsne",
    title: str = "Latent space",
):
    """2-D latent scatter colored by label; t-SNE (sklearn) or PCA projection
    (reference visualization.py:125-202)."""
    plt = _mpl()
    z = np.asarray(latents, np.float32).reshape(len(latents), -1)
    if z.shape[1] > 2:
        if method == "tsne":
            from sklearn.manifold import TSNE

            perplexity = max(2, min(30, len(z) // 4))
            z2 = TSNE(
                n_components=2, perplexity=perplexity, random_state=42, init="pca"
            ).fit_transform(z)
        else:
            import torch

            from medvae_tpu_torch.analysis.latent import pca

            z2 = pca(torch.from_numpy(z), 2)[0].numpy()
    else:
        z2 = z
    fig, ax = plt.subplots(figsize=(7, 6))
    sc = ax.scatter(z2[:, 0], z2[:, 1], c=np.asarray(labels), cmap="tab10", s=8, alpha=0.7)
    fig.colorbar(sc, ax=ax, label="label")
    ax.set_title(f"{title} ({method})")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return None if save_path else fig


def plot_loss_curves(
    history: Dict[str, Sequence[float]],
    save_path: Optional[str] = None,
):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, values in history.items():
        ax.plot(values, label=name)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return None if save_path else fig


def read_png_size(path: str) -> tuple:
    """(width, height) of a PNG, from its IHDR chunk, after checking the
    signature and that the image data inflates to the size IHDR states
    (8-bit RGB, one filter byte a row)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    if (depth, color) != (8, 2) or len(zlib.decompress(idat)) != h * (w * 3 + 1):
        raise ValueError(f"{path}: not an 8-bit RGB PNG of {w}x{h}")
    return w, h
