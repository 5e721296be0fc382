"""The port's run surface and the Trainer's last options against the JAX
package on the CPU: the supervisor (`cli/train_resilient.py`) against
`scripts/train_resilient.py` on scripted exit codes and uptimes; SGD against
optax over 12 steps; `data.normalize: false` against JAX's train step; the
towers in bf16 against JAX's bf16 towers, and BiomedCLIPLoss's latent term;
`debug.nan_checks` and `debug.profile` through the Trainer; the serving
bench's `--tiny` run; BENCH_MODE off the card; twelve CVAE train steps
against JAX; and the fixed fault of core/resize.py's kept matrices.

Bars: fp32 outputs, losses and params 2e-4, gradients 5e-4; bf16 towers
against JAX's bf16 towers on the same inputs max abs 4e-3, relative L2 1e-2,
and at most half as far as JAX's fp32 towers are (`_bf16_bars`).
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu.core.mesh import replicate, shard_batch
from medvae_tpu.losses import perceptual as jperc
from medvae_tpu.losses.clip_vit import CLIPViT as JaxCLIPViT
from medvae_tpu.models import ConditionalVAE as JaxCVAE
from medvae_tpu.train import optim as joptim
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu_torch import bench
from medvae_tpu_torch.cli import bench_serve
from medvae_tpu_torch.cli import train_resilient
from medvae_tpu_torch.compat.jax_params import from_jax_grads, from_jax_params
from medvae_tpu_torch.config.compose import compose
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.core import resize as tresize
from medvae_tpu_torch.losses import perceptual as tperc
from medvae_tpu_torch.losses.clip_vit import CLIPViT
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep
from medvae_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
TOL, GRAD_TOL = 2e-4, 5e-4
BF16_ABS, BF16_REL = 4e-3, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads (ROADMAP's test-time budget)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ----------------------------------------------------------- supervisor ---- #


def _jax_supervise():
    spec = importlib.util.spec_from_file_location("jax_train_resilient", ROOT / "scripts" / "train_resilient.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.supervise


# the eight cases of tests/test_resilient.py: (args, outcomes as (exit code,
# uptime), supervisor options)
SUPERVISED = {
    "success_first_try": (["experiment=quick"], [(0, 500)], {}),
    "crash_then_resume": (["experiment=quick"], [(1, 900), (1, 900), (0, 900)], {"backoff_s": 30}),
    "fast_double_failure": (["experiment=broken"], [(2, 5), (2, 5), (0, 5)], {"min_uptime_s": 120}),
    "fast_failure_budget": (["e=x"], [(1, 5)] * 5 + [(0, 900)], {"min_uptime_s": 120, "max_fast_failures": 10}),
    "long_uptime_resets": (["e=x"], [(1, 5), (1, 900), (1, 5), (1, 900), (0, 900)], {"min_uptime_s": 120}),
    "restart_budget": (["e=x"], [(7, 900)] * 4, {"max_restarts": 3}),
    "resume_not_duplicated": (["e=x", "+resume=true"], [(1, 900), (0, 900)], {}),
    "backoff_capped": (["e=x"], [(1, 900)] * 4 + [(0, 900)], {"backoff_s": 100, "max_backoff_s": 150}),
}


def _scripted(supervise, args, outcomes, options):
    """(argv of each launch, sleeps, return code) of `supervise` on a runner
    that plays `outcomes`, its clock advanced by their uptimes."""
    clock, calls, slept, it = [0.0], [], [], iter(outcomes)

    def runner(argv):
        calls.append(list(argv))
        code, uptime = next(it)
        clock[0] += uptime
        return code

    code = supervise(list(args), runner=runner, sleeper=slept.append, clock=lambda: clock[0], **options)
    return calls, slept, code


@pytest.mark.parametrize("case", sorted(SUPERVISED))
def test_supervisor_matches_the_jax_script(case, capsys):
    args, outcomes, options = SUPERVISED[case]
    got = _scripted(train_resilient.supervise, args, outcomes, options)
    assert got == _scripted(_jax_supervise(), args, outcomes, options)
    if case == "crash_then_resume":  # the launches resume once, then keep resuming
        assert got[0] == [args, args + ["+resume=true"], args + ["+resume=true"]] and got[1] == [30, 60]


def test_supervisor_cli_launches_the_port_and_parses_the_jax_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(train_resilient, "supervise", lambda args, **kw: seen.update(args=args, **kw) or 0)
    assert train_resilient.main(["--max-restarts", "3", "--backoff", "1", "--max-backoff", "2",
                                 "--min-uptime", "5", "--max-fast-failures", "4", "--", "experiment=x"]) == 0
    assert seen == {"args": ["experiment=x"], "max_restarts": 3, "backoff_s": 1.0, "max_backoff_s": 2.0,
                    "min_uptime_s": 5.0, "max_fast_failures": 4}
    assert train_resilient.train_command(["a=1"])[1:] == ["-m", "medvae_tpu_torch.cli.train", "a=1"]
    with pytest.raises(SystemExit):
        train_resilient.main(["experiment=x"])


# ------------------------------------------------------------------ SGD ---- #


@pytest.mark.parametrize("clip", [None, 0.5])
def test_sgd_matches_optax_over_twelve_steps(clip):
    """zero_nans, the optional clip, then optax.sgd's momentum trace, a NaN
    gradient entry at step 3, a cosine schedule."""
    rs = np.random.RandomState(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    cfg = ({"type": "sgd", "lr": 0.05, "momentum": 0.8}, {"type": "cosine", "T_max": 3})
    jtx = joptim.build_optimizer(*cfg, steps_per_epoch=4, gradient_clip_val=clip)
    ttx = toptim.build_optimizer(*cfg, steps_per_epoch=4, gradient_clip_val=clip)
    jp, jst = list(map(jnp.asarray, params)), None
    jst = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tst = ttx.init(tp)
    for step in range(12):
        grads = [rs.randn(*s).astype(np.float32) for s in shapes]
        if step == 3:
            grads[1][2] = np.nan
        updates, jst = jtx.update(list(map(jnp.asarray, grads)), jst, jp)
        jp = optax.apply_updates(jp, updates)
        tupd, tst = ttx.update([torch.from_numpy(g) for g in grads], tst, tp)
        for p, u in zip(tp, tupd):
            p.add_(u)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert tst.count == 12 and tst.nu == [] and all(np.isfinite(p.numpy()).all() for p in tp)


# ------------------------------------------------ normalize, CVAE steps ---- #

SMALL = dict(input_channels=3, latent_dim=4, hidden_channels=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=(16,), resolution=16)
LOSS = {"type": "vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0}
OPT = ({"type": "adam", "lr": 1e-3}, {"type": "constant"})
B = 6


def _cvae():
    jm = JaxCVAE(**SMALL)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                 jnp.zeros((2, 16, 16, 3)), jnp.zeros((2, 12)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = build_model(dict(SMALL, _target_="medvae_tpu.models.ConditionalVAE"), "fp32", "cpu", train=True)
    model.load_state_dict(from_jax_params(params, model))
    return jm, params, model


def _batches(n, seed=3):
    rs = np.random.RandomState(seed)
    midx = np.arange(B) % 5
    return [{"image_u8": rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8),
             "modality_onehot": np.eye(12, dtype=np.float32)[midx], "modality_idx": midx.astype(np.int32),
             "channels": np.array([1, 3, 3, 1, 3])[midx].astype(np.int32),
             "noise": rs.randn(B, 8, 8, 4).astype(np.float32)} for _ in range(n)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_unnormalized_images_match_jax_loss_and_gradients():
    """data.normalize=false: images stay in [0, 1] (the padding channels 0),
    the loss and its gradients those of JAX's step."""
    jm, params, model = _cvae()
    batch = _batches(1)[0]
    jcrit, forward = jstep.make_criterion(LOSS, jm), jstep.make_forward_fn(jm)

    def jloss(p, b):
        x = jstep.preprocess(b, None, augment=False, normalize=False, max_channels=3)
        return jcrit({}, forward(p, x, b, {"sample": jax.random.PRNGKey(0)}), x)["loss"]

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_grads = jax.jit(jax.value_and_grad(jloss))(params, jb)
    state = tstate.create_train_state(model, toptim.build_optimizer(*OPT))
    losses, grads = tstep.build_loss_and_grads(model, LOSS, normalize=False)(state, _torch_batch(batch))
    np.testing.assert_allclose(float(losses["loss"]), float(want), atol=TOL, rtol=0)
    want_grads = from_jax_grads(jax.tree_util.tree_map(np.asarray, want_grads), model)
    for name, g in zip(state.params, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=GRAD_TOL, rtol=0, err_msg=name)
    x = tstep.preprocess(_torch_batch(batch), augment=False, max_channels=3, normalize=False)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    np.testing.assert_array_equal(x.numpy(), np.asarray(jstep.preprocess(jb, None, augment=False, normalize=False,
                                                                          max_channels=3)))


CVAE_STEPS = 12


def test_twelve_cvae_steps_match_jax():
    """The 3-step CVAE parity of tests/test_torch_port_cvae.py taken to 12
    steps (adam 1e-3, clip 1.0): every loss term each step 2e-4, and the
    params after the twelfth 2e-4. Elements whose step-one gradient is
    rounding noise around zero (|g| < 1e-6: the whole bias of a conv before
    a GroupNorm of one channel a group, which the norm removes, and stray
    weights) are held to Adam's bound instead, 2·lr a step: Adam's
    normalized update moves them by about lr a step whatever the noise's
    size, in either package."""
    jm, params, model = _cvae()
    batches = _batches(CVAE_STEPS)
    state0 = tstate.create_train_state(model, toptim.build_optimizer(*OPT))
    _, step_one = tstep.build_loss_and_grads(model, LOSS)(state0, _torch_batch(batches[0]))
    noise = {name: g.abs() < 1e-6 for name, g in zip(state0.params, step_one)}
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jtx = joptim.build_optimizer(*OPT, gradient_clip_val=1.0)
    jtrain = jstep.build_train_step(jm, LOSS, jtx, mesh, augment=False, max_channels=3, donate=False)
    jst = replicate(mesh, jstate.create_train_state(params, jtx))
    ttx = toptim.build_optimizer(*OPT, gradient_clip_val=1.0)
    tst = tstate.create_train_state(model, ttx)
    train = tstep.build_train_step(model, LOSS, ttx, augment=False, max_channels=3)
    for i, batch in enumerate(batches):
        jst, jm_ = jtrain(jst, shard_batch(mesh, batch), jax.random.PRNGKey(2))
        tst, tm = train(tst, _torch_batch(batch))
        for key in ("train/loss", "train/recon_loss", "train/kl_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm_[key]), atol=TOL, rtol=0, err_msg=f"{key} {i}")
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jst.params), model)
    adam_bound = 2 * OPT[0]["lr"] * CVAE_STEPS
    for name, p in tst.params.items():
        diff = (p.detach() - want[name]).abs().numpy()
        mask = noise[name].numpy()
        assert diff[~mask].max(initial=0.0) <= TOL, (name, diff[~mask].max())
        assert diff[mask].max(initial=0.0) <= adam_bound, name
    assert sum(int(m.sum()) for m in noise.values()) < 0.01 * sum(m.numel() for m in noise.values())


# --------------------------------------------------------------- towers ---- #


def _bf16_bars(got, want, fp32, port_fp32):
    """A tower's bf16 output `got` against JAX's bf16 output `want` on the
    same inputs: max abs 4e-3 and relative L2 1e-2, and at most half as far
    from `want` as JAX's fp32 output `fp32` is, so that a tower computing in
    fp32 would fail; the port's own fp32 output `port_fp32` is shown to fail
    that last bar. JAX's outputs come from `_exact`."""
    got, want, fp32, port_fp32 = (np.asarray(v, np.float64) for v in (got, want, fp32, port_fp32))
    gap = np.linalg.norm(fp32 - want)
    assert np.abs(got - want).max() <= BF16_ABS, np.abs(got - want).max()
    assert np.linalg.norm(got - want) <= BF16_REL * np.linalg.norm(want)
    assert np.linalg.norm(got - want) <= 0.5 * gap, (np.linalg.norm(got - want), gap)
    assert np.linalg.norm(port_fp32 - want) > 0.5 * gap, (np.linalg.norm(port_fp32 - want), gap)


def _exact(fn, *args):
    """`fn(*args)` jitted with every op rounded to its dtype: under plain jit
    on the CPU, XLA keeps fp32 between the ops of a fusion
    (`xla_allow_excess_precision`) and skips bf16 roundings that the
    tower's dtype asks for (op-by-op JAX gives the same numbers, slower)."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


def _imgs(seed, size, n=2):
    return np.tanh(np.random.RandomState(seed).randn(n, size, size, 3)).astype(np.float32)


def test_lpips_in_bf16_matches_jax_bf16():
    jl, jl32 = jperc.LPIPSLoss(dtype=jnp.bfloat16), jperc.LPIPSLoss()
    variables = jax.jit(jl.init, static_argnums=1)(jax.random.PRNGKey(11), 64)
    net = tperc.LPIPSNet().requires_grad_(False)
    net.load_state_dict(from_jax_params(variables["params"], net))
    a, b = _imgs(1, 64), _imgs(2, 64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = net(ta, tb, torch.bfloat16)
    assert got.dtype == torch.float32  # the lin heads and the mean reduce in fp32
    _bf16_bars(got.numpy(), _exact(jl.module.apply, variables, a, b), _exact(jl32.module.apply, variables, a, b),
               net(ta, tb, torch.float32).numpy())
    loss = tperc.LPIPSLoss(dtype=torch.bfloat16)(net, ta, tb)
    _bf16_bars(float(loss), _exact(jl, variables, a, b), _exact(jl32, variables, a, b),
               float(tperc.LPIPSLoss()(net, ta, tb)))


@pytest.mark.parametrize("encoder", ["simple", "vit"])
def test_clip_towers_in_bf16_match_jax_bf16(encoder):
    """SimpleCLIP at full size, the ViT at the smallest size its classes
    take (width 64, 2 layers, 4 heads, embed 32; 224² in, 49 patches): the
    embeddings of one preprocessed input (JAX's preprocessing of 32² images,
    fed to both towers) under the bf16 bars; the loss of 32² images within
    relative 1e-2 (each package's own cubic resize to 224² differs in the
    last fp32 bits, and bf16 roundings of the two inputs then part as far
    as the fp32 towers' do)."""
    jl, jl32 = jperc.BiomedCLIPLoss(encoder=encoder, dtype=jnp.bfloat16), jperc.BiomedCLIPLoss(encoder=encoder)
    if encoder == "vit":
        small = dict(width=64, layers=2, heads=4, embed_dim=32)
        jl.module, jl32.module, net = JaxCLIPViT(**small, dtype=jnp.bfloat16), JaxCLIPViT(**small), CLIPViT(**small)
    else:
        net = tperc.SimpleCLIPEncoder()
    variables = jax.jit(jl.init)(jax.random.PRNGKey(13))
    net.requires_grad_(False).load_state_dict(from_jax_params(variables["params"], net))
    loss = tperc.BiomedCLIPLoss(encoder=encoder, dtype=torch.bfloat16)
    img, rec = _imgs(3, 32), _imgs(4, 32)
    x = jl._preprocess(jnp.asarray(img))
    got = net(torch.from_numpy(np.array(x)), torch.bfloat16).float()
    _bf16_bars(got.numpy(), _exact(jl.module.apply, variables, x).astype(jnp.float32),
               _exact(jl32.module.apply, variables, x), net(torch.from_numpy(np.array(x))).numpy())
    want = float(jax.jit(lambda v, i, r: jl(v, i, rec=r))(variables, jnp.asarray(img), jnp.asarray(rec)))
    assert abs(float(loss(net, torch.from_numpy(img), torch.from_numpy(rec))) - want) <= BF16_REL * abs(want)


def test_biomedclip_latent_term_matches_jax():
    """compute_lat_loss at fp32: latent / 4.6, pooled over channels, resized
    to 224² linearly, tiled to 3 channels, without the CLIP normalization."""
    jl = jperc.BiomedCLIPLoss(compute_rec_loss=True, compute_lat_loss=True, encoder="simple")
    variables = jax.jit(jl.init)(jax.random.PRNGKey(5))
    net = tperc.SimpleCLIPEncoder()
    net.load_state_dict(from_jax_params(variables["params"], net))
    img, rec = _imgs(5, 28), _imgs(6, 28)
    lat = np.random.RandomState(7).randn(2, 7, 7, 4).astype(np.float32) * 3
    tl = tperc.BiomedCLIPLoss("simple", compute_rec_loss=True, compute_lat_loss=True)
    for r in (rec, None):
        want = jax.jit(lambda v, i, r_, z: jl(v, i, rec=r_, latent=z))(
            variables, jnp.asarray(img), None if r is None else jnp.asarray(r), jnp.asarray(lat))
        got = tl(net, torch.from_numpy(img), None if r is None else torch.from_numpy(r), torch.from_numpy(lat))
        np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_bf16_towers_reach_the_train_step():
    """loss.tower_dtype=bfloat16 sets the compute dtype of every tower the
    loss types build, with their params fp32."""
    for cfg in ({"type": "lpips"}, {"type": "biomedclip"},
                {"type": "disentangled_vae", "perceptual_weight": 0.1, "biomedclip_weight": 0.1},
                {"type": "lpips_discriminator", "use_biomedclip_loss": True}):
        cfg = dict(cfg, tower_dtype="bfloat16")
        assert tstep._tower_dtype(cfg) == torch.bfloat16
        frozen = tstep.make_frozen(cfg, "cpu")
        assert all(p.dtype == torch.float32 for t in frozen.values() for p in t.parameters())
    gan = tstep.make_gan_loss({"type": "lpips_discriminator", "use_biomedclip_loss": True,
                               "tower_dtype": "bfloat16"})
    assert gan.perceptual_loss.dtype == gan.biomed_clip_loss.dtype == torch.bfloat16


# -------------------------------------------------- Trainer debug options ---- #

QUICK = ["experiment=chest_base_vae_quick", "device=cpu", "training.max_epochs=1", "+training.limit_train_batches=2",
         "early_stopping.enabled=false", "data.batch_size=32", "model.hidden_channels=8", "model.ch_mult=[1,2]",
         "model.latent_dim=4", "training.log_every_n_steps=100", "training.log_images_every_n_epochs=0"]


def _trainer(work, *extra):
    from medvae_tpu_torch.cli.train import default_config_dir

    return Trainer(compose(default_config_dir(), "config", [*QUICK, f"work_dir={work}", *extra]))


class _NanFeeder:
    """The train feeder's batches with one image of batch `at` NaN (float
    images pass through the step's uint8 → float cast)."""

    def __init__(self, feeder, at):
        self.feeder, self.at = feeder, at
        self.steps_per_epoch = feeder.steps_per_epoch

    def epoch(self, epoch):
        for i, batch in enumerate(self.feeder.epoch(epoch)):
            if i == self.at:
                image = batch["image_u8"].float()
                image[0] = float("nan")
                batch = dict(batch, image_u8=image)
            yield batch


def test_nan_checks_raise_on_a_nan_batch_and_change_nothing_on_a_clean_run(tmp_path, capsys):
    runs = {}
    for tag, extra in (("off", []), ("on", ["debug.nan_checks=true"])):
        t = _trainer(tmp_path / tag, "+data.device_cache=true", "training.check_val_every_n_epoch=1000", *extra)
        t.fit()
        runs[tag] = {k: v.detach().clone() for k, v in t.state.params.items()}
    assert all(torch.equal(runs["on"][k], runs["off"][k]) for k in runs["off"])
    assert "fused_steps=auto: off under debug.nan_checks" in capsys.readouterr().out
    t = _trainer(tmp_path / "nan", "debug.nan_checks=true", "+data.device_cache=false",
                 "training.check_val_every_n_epoch=1000")
    t._feeders[("train", True, True)] = _NanFeeder(t._feeder("train", True, True), at=1)
    with pytest.raises(FloatingPointError, match=r"NaN in metric train/loss at train step 1 "):
        t.fit()
    assert t.state.step == 1  # the step with the NaN batch did not update


def test_profile_writes_a_trace_of_the_first_steps(tmp_path, capsys):
    t = _trainer(tmp_path, "debug.profile=true", "+training.fused_steps=on", "+data.device_cache=true")
    t.fit()
    path = os.path.join(t.logger.dir, "profile", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("conv" in str(n) for n in names)
    assert "fused_steps=on: off under debug.profile" in capsys.readouterr().out
    with open(os.path.join(t.logger.dir, "profile", "spans.json")) as f:
        spans = json.load(f)["spans"]  # the port's spans of the profiled steps, beside the trace
    steps = [s for s in spans if s["name"] == "step"]
    assert steps and all(s["end_ns"] >= s["start_ns"] for s in steps)
    assert {s["name"] for s in spans if s["parent"] == steps[0]["id"]} >= {"step.forward", "step.optimizer"}


def test_unnormalized_run_trains_with_finite_losses(tmp_path, capsys):
    t = _trainer(tmp_path, "data.normalize=false")
    assert t.normalize is False and t.train_step.normalize is False
    val = t.fit()
    assert np.isfinite(val["val/loss"])


# ------------------------------------------------------------- benches ---- #


def test_bench_serve_tiny_writes_every_cell(tmp_path, capsys):
    assert bench_serve.main(["--tiny", "--out", str(tmp_path)]) == 0
    results = json.loads((tmp_path / "results.json").read_text())
    (surface,) = results["surfaces"]
    cells = {(c["method"], c["bucket"]) for c in surface["cells"]}
    assert cells == {(m, b) for m in ("reconstruct", "encode", "decode", "sample") for b in (1, 4)}
    assert all(c["ms_per_batch"] > 0 and c["images_per_sec"] > 0 for c in surface["cells"])
    assert {"p50", "p99", "n"} <= set(surface["single_image_latency_ms"])
    assert surface["microbatcher"]["requests"] == 12 and surface["microbatcher"]["achieved_req_per_sec"] > 0


@pytest.mark.parametrize("mode", ["step", "pipeline", "generate"])
def test_bench_modes_refuse_to_run_off_the_card(mode, monkeypatch):
    monkeypatch.setenv("BENCH_MODE", mode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main()


def test_bench_pipeline_split_and_generation_model_build_on_the_cpu():
    split = bench.synthetic_split(20, 28)
    assert split.images.shape == (20, 28, 28, 3) and list(split.modality_idx[:6]) == [0, 1, 2, 3, 4, 0]
    net = build_model(bench.GENERATE_MODEL, "fp32", "cpu")
    out = net.sample_conditional(5, torch.arange(5) % 5, generator=torch.Generator().manual_seed(0))
    assert out.shape == (5, 28, 28, 3) and bool(torch.isfinite(out).all())


# ------------------------------------------------------ the fixed fault ---- #


def test_a_matrix_first_made_in_inference_mode_still_trains():
    """core/resize.py and the towers' constants keep what they make; made
    first under torch.inference_mode() (the engine's), they were inference
    tensors, and a later backward in the same process raised "Inference
    tensors cannot be saved for backward" (tests/test_torch_port_gan.py's
    cvae_runs under the test runner's workers, after the export tests)."""
    size = (5, 13)  # a resize no other test makes
    tresize._matrices.clear()
    tperc._constants.clear()
    with torch.inference_mode():
        tresize.resize(torch.ones(1, *size[:1], size[0], 3), size[1], "linear")
        tperc._constant((0.5, 0.25, 0.125), torch.ones(3), torch.float32)
    x = torch.ones(1, size[0], size[0], 3, requires_grad=True)
    y = tresize.resize(x, size[1], "linear") * tperc._constant((0.5, 0.25, 0.125), x, torch.float32)
    y.sum().backward()
    assert x.grad is not None and not any(m.is_inference() for m in tresize._matrices.values())
