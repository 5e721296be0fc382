"""The port's analysis functions and image grids on the CPU, against the JAX
package on the same numpy arrays (seeded).

Distances, centroids and silhouette within 1e-5; `pca` with fewer samples
than dimensions (the port's Gram form) and with more (the covariance, as
JAX): projections equal up to each component's sign within 1e-4 of their
scale, explained-variance ratios 1e-5; `fid_score` 1e-3 relative (fp32
eigendecompositions), the reference's quirk 1e-10 (both float64 numpy); MIG
and the β-VAE probe equal (the same sklearn calls); `latent_interpolation`
exact. The port's PNG writer against JAX's PIL one: both files decoded with
PIL, uint8 equal, gray and RGB, `cols` set and unset; the recon and sample
grids' panel layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from medvae_tpu import analysis as janalysis
from medvae_tpu.utils import visualization as jvis
from medvae_tpu_torch import analysis as tanalysis
from medvae_tpu_torch.utils import visualization as tvis


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _clusters(seed, n_per=12, d=20, classes=4, spread=3.0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d).astype(np.float32) * spread
    labels = np.repeat(np.arange(classes), n_per).astype(np.int32)
    z = centers[labels] + rs.randn(len(labels), d).astype(np.float32)
    return z, labels


def test_distances_centroids_and_silhouette_match_jax():
    z, labels = _clusters(0)
    labels[-3:] = 5  # class 4 empty, class 5 small
    t = torch.from_numpy
    np.testing.assert_allclose(tanalysis.pairwise_distances(t(z)).numpy(),
                               np.asarray(janalysis.pairwise_distances(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)
    assert tanalysis.pairwise_distances(t(z)).diagonal().abs().max().item() == 0.0
    got_d, got_c = tanalysis.centroid_distance_matrix(t(z), t(labels), 6)
    want_d, want_c = janalysis.centroid_distance_matrix(jnp.asarray(z), jnp.asarray(labels), 6)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    got = float(tanalysis.silhouette_score(t(z), t(labels), 6))
    want = float(janalysis.silhouette_score(jnp.asarray(z), jnp.asarray(labels), 6))
    assert abs(got - want) <= 1e-5 and 0.3 < got < 1.0


@pytest.mark.parametrize("n, d", [(200, 12), (24, 300)], ids=["D<N covariance", "N<D gram"])
def test_pca_matches_jax_up_to_sign(n, d):
    rs = np.random.RandomState(n + d)
    # two well-separated leading directions, then noise
    basis = np.linalg.qr(rs.randn(d, 2))[0].T
    x = (rs.randn(n, 1) * 6.0 * basis[0] + rs.randn(n, 1) * 3.0 * basis[1]
         + rs.randn(n, d) * 0.3 + 5.0).astype(np.float32)
    got_p, got_r = tanalysis.pca(torch.from_numpy(x), 2)
    want_p, want_r = (np.asarray(a) for a in janalysis.pca(jnp.asarray(x), 2))
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-5, atol=1e-5)
    for k in range(2):
        sign = np.sign(np.dot(got_p[:, k].numpy(), want_p[:, k]))
        scale = np.abs(want_p[:, k]).max()
        np.testing.assert_allclose(sign * got_p[:, k].numpy(), want_p[:, k], atol=1e-4 * scale)


def test_fid_and_the_reference_quirk_match_jax():
    rs = np.random.RandomState(3)
    # a shared factor makes every covariance entry positive, so the quirk's
    # element-wise sqrt of Σ₁Σ₂ is real
    real = (rs.randn(300, 1) + 0.5 * rs.randn(300, 16)).astype(np.float32)
    fake = (0.8 * rs.randn(300, 1) + 0.4 * rs.randn(300, 16) + 0.2).astype(np.float32)
    want = janalysis.fid_score(real, fake)
    assert abs(tanalysis.fid_score(real, fake) - want) <= 1e-3 * abs(want)
    assert abs(tanalysis.fid_score(torch.from_numpy(real), torch.from_numpy(fake)) - want) <= 1e-3 * abs(want)
    quirk = tanalysis.fid_score_reference_quirk(real, fake)
    assert np.isfinite(quirk) and want > 0
    np.testing.assert_allclose(quirk, janalysis.fid_score_reference_quirk(real, fake), rtol=1e-10)


def test_mig_and_beta_vae_metric_equal_jax():
    z, labels = _clusters(5, n_per=20, d=6)
    assert tanalysis.compute_disentanglement_metrics(z, labels[:, None]) == \
        janalysis.compute_disentanglement_metrics(z, labels[:, None])


def test_latent_interpolation_is_jax_exactly():
    rs = np.random.RandomState(7)
    a, b = rs.randn(2, 4, 4, 3).astype(np.float32)
    for steps in (2, 4, 7):
        got = tanalysis.latent_interpolation(torch.from_numpy(a), torch.from_numpy(b), steps).numpy()
        want = np.asarray(janalysis.latent_interpolation(jnp.asarray(a), jnp.asarray(b), steps))
        np.testing.assert_array_equal(got, want)


def _decoded(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("channels, cols", [(1, None), (3, None), (1, 4), (3, 5)])
def test_png_grids_decode_to_the_jax_pixels(tmp_path, channels, cols):
    images = np.random.RandomState(channels).uniform(-1, 1, (7, 9, 11, channels)).astype(np.float32)
    tvis.save_image_grid(images, str(tmp_path / "port.png"), cols=cols)
    jvis.save_image_grid(images, str(tmp_path / "jax.png"), cols=cols)
    got = _decoded(tmp_path / "port.png")
    np.testing.assert_array_equal(got, _decoded(tmp_path / "jax.png"))
    assert tvis.read_png_size(str(tmp_path / "port.png")) == (got.shape[1], got.shape[0])
    tvis.save_image(images[2], str(tmp_path / "one_port.png"))
    jvis.save_image(images[2], str(tmp_path / "one_jax.png"))
    np.testing.assert_array_equal(_decoded(tmp_path / "one_port.png"), _decoded(tmp_path / "one_jax.png"))


def test_recon_and_sample_grids_lay_out_the_jax_panels(tmp_path):
    rs = np.random.RandomState(9)
    x = rs.uniform(-1, 1, (10, 6, 6, 1)).astype(np.float32)
    rec = rs.uniform(0, 1, (10, 6, 6, 1)).astype(np.float32)
    grid = tvis.plot_reconstructions(x, rec, str(tmp_path / "recon.png"), num_samples=8)
    assert grid.shape == (2 * 8 + 2, 8 * 8 + 2, 3)
    np.testing.assert_array_equal(_decoded(tmp_path / "recon.png"), grid)
    # originals in the top row, their reconstructions below, each panel
    # rescaled on its own as the JAX figure's imshow does
    np.testing.assert_array_equal(grid[2:8, 10:16, 0], (tvis.to_unit(x[1])[..., 0] * 255).astype(np.uint8))
    np.testing.assert_array_equal(grid[10:16, 2:8, 0], (tvis.to_unit(rec[0])[..., 0] * 255).astype(np.uint8))
    samples = rs.uniform(-1, 1, (10, 6, 6, 3)).astype(np.float32)
    grid = tvis.plot_samples(samples, str(tmp_path / "samples.png"), title="ignored")
    assert grid.shape == (3 * 8 + 2, 4 * 8 + 2, 3)  # 10 panels near-square: 3 rows of 4
    np.testing.assert_array_equal(grid[18:24, 10:16], (tvis.to_unit(samples[9]) * 255).astype(np.uint8))
    assert (grid[18:24, 18:] == 255).all()  # panels past the samples stay blank
    assert tvis.plot_samples(samples, grid=(2, 6)).shape == (2 * 8 + 2, 6 * 8 + 2, 3)
