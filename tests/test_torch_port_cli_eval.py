"""The port's evaluation, generation and analysis CLIs on the CPU, against
the JAX package's.

One module fixture: two tiny JAX models, initialised and not trained (the
quick flagship experiment at 28² and the quick chest BaseVAE, hidden 8,
ch_mult [1, 2], two of the flagship's five datasets, fp32), each saved with
orbax beside its composed `config.yaml`, and converted by `from_jax_params`
into a port checkpoint directory with the same `config.yaml`. On them:
`analyze`'s encoded path by both packages (results.json within 1e-4);
`eval_batch` of each model family against the JAX CLI's formula
(evaluate.py:78-108, recomputed here from JAX's model with the same noise)
at 2e-4, the eval step's bar; the `evaluate` CLI by both packages (the
same metrics.json keys, the noise-free KL statistics within 2e-4);
`generate`'s file names for each flag set against JAX's, and its
interpolation rows against JAX's decode of the same latents at 2e-4;
`--use_ema` on a hand-built checkpoint; and each CLI's refusal to run
without a card unless asked for the CPU.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import yaml

from medvae_tpu.cli import analyze as janalyze
from medvae_tpu.cli import evaluate as jevaluate
from medvae_tpu.cli import generate as jgenerate
from medvae_tpu.config import compose as jax_compose
from medvae_tpu.data.pipeline import normalize_and_augment
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.models import DisentangledConditionalVAE as JaxDCVAE
from medvae_tpu.train import metrics as jmetrics
from medvae_tpu.train.trainer import build_model as jax_build_model
from medvae_tpu_torch.cli import analyze, evaluate, generate
from medvae_tpu_torch.cli import serve as cli_serve
from medvae_tpu_torch.cli.common import load_model, load_model_and_params, save_checkpoint
from medvae_tpu_torch.compat.jax_params import from_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.serve.engine import InferenceEngine

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
TINY = ["device=cpu", "precision=fp32", "data.batch_size=32", "model.hidden_channels=8",
        "model.ch_mult=[1,2]"]
RUNS = {
    "flagship": ["experiment=disentangled_multi_modal_cvae_quick",
                 "data.dataset_names=[chestmnist,pathmnist]"],
    "base": ["experiment=chest_base_vae_quick", "model.latent_dim=4"],
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _init_args(model, size, channels):
    args = [jnp.zeros((2, size, size, channels))]
    if isinstance(model, JaxCVAE):
        args.append(jnp.zeros((2, 12)))
    if isinstance(model, JaxDCVAE):
        args.append(jnp.zeros((2,), jnp.int32))
    return args


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (JAX snapshot dir, port snapshot dir, JAX model, its params)}."""
    out = {}
    for name, overrides in RUNS.items():
        work = tmp_path_factory.mktemp(f"cli_eval_{name}")
        cfg = jax_compose(CONFIGS, "config", [*overrides, *TINY, f"work_dir={work}"]).to_dict()
        jm = jax_build_model(cfg["model"], precision="fp32", use_pallas=True)
        size = int(cfg["model"]["resolution"])
        channels = 3 if isinstance(jm, JaxDCVAE) else int(cfg["model"]["input_channels"])
        params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                  *_init_args(jm, size, channels))["params"]
        dirs = []
        for package in ("jax", "port"):
            os.makedirs(work / package)
            with open(work / package / "config.yaml", "w") as f:
                yaml.safe_dump(cfg, f)
            dirs.append(str(work / package / "snapshot"))
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(dirs[0], {"params": params})
        ckptr.wait_until_finished()
        model = build_model(cfg["model"], "fp32", "cpu")
        os.makedirs(dirs[1])
        save_checkpoint(os.path.join(dirs[1], "checkpoint.pt"), from_jax_params(_host(params), model),
                        cfg["model"], "fp32")
        out[name] = (dirs[0], dirs[1], jm, params)
    return out


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_analyze_encoded_matches_jax(runs, tmp_path):
    jdir, pdir, _, _ = runs["flagship"]
    args = ["--samples_per_modality", "16"]
    assert janalyze.main(["--model_path", jdir, "--output_dir", str(tmp_path / "jax"), *args]) == 0
    assert analyze.main(["--model_path", pdir, "--output_dir", str(tmp_path / "port"), "--device", "cpu",
                         *args]) == 0
    want, got = _read(tmp_path / "jax" / "results.json"), _read(tmp_path / "port" / "results.json")
    assert set(got) == set(want) and got["verdict"] == want["verdict"]
    for k in want:
        if k != "verdict":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    npz = np.load(tmp_path / "port" / "latent_analysis.npz")
    assert npz["latents"].shape == (32, 14 * 14 * 16) and sorted(np.unique(npz["labels"])) == [0, 1]
    assert (tmp_path / "port" / "latent_analysis.png").exists()


CODEC = dict(hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(), resolution=16)
FAMILIES = {
    "BaseVAE": (JaxBaseVAE, dict(CODEC, input_channels=3, latent_dim=4)),
    "ConditionalVAE": (JaxCVAE, dict(CODEC, input_channels=3, latent_dim=4)),
    "DisentangledConditionalVAE": (
        JaxDCVAE, dict(CODEC, num_modalities=5, shared_latent_dim=4, modality_latent_dim=4)),
}


def _jax_eval_batch(jm, params, batch, noise):
    """The JAX CLI's eval_batch (medvae_tpu/cli/evaluate.py:78-108) with the
    reparameterization draw given."""
    x = normalize_and_augment(batch["image_u8"], None, augment=False, dtype=jm.dtype)
    mask = (jnp.arange(3)[None, :] < batch["channels"][:, None]).astype(x.dtype)
    x = x * mask[:, None, None, :]
    cond = ([batch["modality_idx"]] if isinstance(jm, JaxDCVAE)
            else [batch["modality_onehot"]] if isinstance(jm, JaxCVAE) else [])
    out = jm.apply({"params": params}, x, *cond, noise=noise)
    m = {**jmetrics.reconstruction_metrics(out["reconstruction"], x, batch["valid"]),
         **jmetrics.kl_metrics(out["mean"], out["logvar"], batch["valid"]),
         **jmetrics.latent_metrics(out["z"], batch["valid"])}
    onehot = jax.nn.one_hot(batch["modality_idx"], 12, dtype=jnp.float32) * batch["valid"][:, None]
    per_sample = jmetrics.psnr(out["reconstruction"].astype(jnp.float32), x.astype(jnp.float32))
    m["_psnr_by_mod"] = jnp.sum(per_sample[:, None] * onehot, axis=0)
    m["_count_by_mod"] = jnp.sum(onehot, axis=0)
    return m, x, out["reconstruction"], out["mean"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_batch_matches_the_jax_formula(family):
    cls, arch = FAMILIES[family]
    b = 6
    rs = np.random.RandomState(21)
    midx = np.array([0, 1, 2, 3, 4, 1], np.int32)
    batch = {"image_u8": rs.randint(0, 256, (b, 16, 16, 3)).astype(np.uint8), "modality_idx": midx,
             "modality_onehot": np.eye(12, dtype=np.float32)[midx],
             "channels": np.array([1, 3, 3, 1, 3, 3], np.int32),
             "valid": np.array([1, 1, 1, 1, 0, 1], np.float32)}
    noise = rs.randn(b, 8, 8, 8 if cls is JaxDCVAE else 4).astype(np.float32)
    jm = cls(**arch)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                              *_init_args(jm, 16, 3))["params"]
    want = _jax_eval_batch(jm, params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(noise))
    model = build_model(dict(arch, _target_=family), "fp32", "cpu")
    model.load_state_dict(from_jax_params(_host(params), model))
    got = evaluate.eval_batch(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                              noise=torch.from_numpy(noise))
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]), rtol=2e-4, atol=2e-4, err_msg=k)
    for g, w, name in zip(got[1:], want[1:], ("x", "reconstruction", "mean")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=name)


def test_evaluate_cli_matches_jax(runs, tmp_path):
    jdir, pdir, _, _ = runs["flagship"]
    args = ["--max_batches", "2", "--split", "val"]
    assert jevaluate.main(["--model_path", jdir, "--output_dir", str(tmp_path / "jax"), *args]) == 0
    assert evaluate.main(["--model_path", pdir, "--output_dir", str(tmp_path / "port"), "--device", "cpu",
                          *args]) == 0
    want, got = _read(tmp_path / "jax" / "metrics.json"), _read(tmp_path / "port" / "metrics.json")
    assert set(got) == set(want)
    for k in ("kl_total", "kl_mean", "kl_std", "kl_per_dim_mean"):  # the encoder's alone: no noise
        for stat in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(got[k][stat], want[k][stat], rtol=2e-4, atol=2e-4, err_msg=(k, stat))
    assert got["psnr_chestmnist"]["count"] == want["psnr_chestmnist"]["count"] == 64
    for name in ("reconstructions.png", "prior_samples.png", "latent_tsne.png"):
        assert (tmp_path / "port" / name).exists(), name
    # --fid (the port's own tower) and --mig on a batch
    assert evaluate.main(["--model_path", pdir, "--output_dir", str(tmp_path / "fid"), "--device", "cpu",
                          "--max_batches", "1", "--fid", "--mig"]) == 0
    extra = _read(tmp_path / "fid" / "metrics.json")
    assert all(np.isfinite(extra[k]["value"]) for k in ("fid_recon", "mig", "beta_vae_metric"))


GENERATE_FLAGS = {
    "flagship": [[], ["--per_modality"], ["--modality", "pathmnist", "--interpolate", "3"]],
    "base": [["--num_seeds", "2"], ["--interpolate", "3", "--grid_size", "2"]],
}


@pytest.mark.parametrize("run, flags", [(r, f) for r, fs in GENERATE_FLAGS.items() for f in fs],
                         ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_generate_writes_the_jax_file_names(runs, tmp_path, run, flags):
    jdir, pdir, _, _ = runs[run]
    args = ["--num_samples", "3", *flags]
    assert jgenerate.main(["--model_path", jdir, "--output_dir", str(tmp_path / "jax"), *args]) == 0
    assert generate.main(["--model_path", pdir, "--output_dir", str(tmp_path / "port"), "--device", "cpu",
                          *args]) == 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_interpolation_rows_equal_jax_decode(runs, run):
    _, pdir, jm, params = runs[run]
    model, _ = load_model_and_params(pdir, device="cpu")
    steps, n = 4, 3
    paths = generate.interpolation_latents(model, 5, steps, n, "cpu")
    rows = generate.interpolation_rows(model, 5, steps, n, "cpu")
    assert len(rows) == (5 if run == "flagship" else 3)
    for (path, midx), row in zip(paths, rows):
        cond = [jnp.asarray(midx.numpy())] if midx is not None else []
        want = jm.apply({"params": params}, jnp.asarray(path.numpy()), *cond, method=jm.decode)
        np.testing.assert_allclose(row, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_use_ema_loads_the_trainers_ema_and_raises_without_one(runs, tmp_path):
    _, pdir, _, _ = runs["base"]
    snap = tmp_path / "snap"
    shutil.copytree(os.path.dirname(pdir), tmp_path, dirs_exist_ok=True)
    os.rename(tmp_path / "snapshot", snap)
    ckpt = torch.load(snap / "checkpoint.pt", weights_only=True)
    ema = {k: v + 0.5 for k, v in ckpt["state_dict"].items()}
    torch.save({**ckpt, "train_state": {"step": 3, "ema": ema}}, snap / "checkpoint.pt")
    model, cfg = load_model_and_params(str(snap), use_ema=True, device="cpu")
    assert cfg["experiment_name"] == "chest_base_vae_quick"
    for k, v in model.state_dict().items():
        assert torch.equal(v, ema[k].to(v.dtype)), k
    raw = load_model(str(snap), "cpu")
    assert not torch.equal(raw.decoder.conv_out.weight, model.decoder.conv_out.weight)
    engine = InferenceEngine.from_checkpoint(str(snap), buckets=(2,), device="cpu", use_ema=True)
    assert torch.equal(engine.model.decoder.conv_out.weight, model.decoder.conv_out.weight)
    torch.save({**ckpt, "train_state": {"step": 3, "ema": None}}, snap / "checkpoint.pt")
    for call in (lambda: load_model_and_params(str(snap), use_ema=True, device="cpu"),
                 lambda: generate.main(["--model_path", str(snap), "--device", "cpu", "--use_ema",
                                        "--output_dir", str(tmp_path / "g")])):
        with pytest.raises(ValueError, match="has no ema_params"):
            call()
    with pytest.raises(ValueError, match="has no ema_params"):
        cli_serve.main(["--model_path", str(snap), "--device", "cpu", "--use_ema", "--no_warmup"])


@pytest.mark.parametrize("cli", [generate, evaluate, analyze], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_each_cli_asks_for_the_card_and_raises_without_one(runs, tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_path", runs["base"][1], "--output_dir", str(tmp_path)])
