"""The port's Trainer fast paths on the CPU, against the JAX package where
it has them.

  * `chunk_plan` against JAX's over a table of cadences;
  * the chunk runner (its CPU loop; on the card replays of one captured
    graph, tests/test_torch_port_cuda.py) against the per-step loop bit for
    bit: plain, GAN (its gate flipping inside the chunk) and eval;
  * `accumulate_grad_batches` 2 and 4 against JAX's step on the same
    weights and pinned noise, plain and GAN: every loss term to 2e-4 and
    the gradients, read from Adam's first moments after the step, to 5e-4
    (the port's fp32 bars);
  * the remat rungs with dropout 0.1 against no remat, forward and
    gradients, bit for bit;
  * `probe_max_batch_size` and `choose_remat` against JAX's with the same
    injected probes;
  * the Trainer: device_cache=true with fused_steps on equal to off, a
    resume in mid chunk plan equal to the uninterrupted run, batch_size=auto
    under a small autobatch_max, remat=auto recorded and reused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu.core.mesh import replicate, shard_batch
from medvae_tpu.losses.perceptual import LPIPSLoss as JaxLPIPSLoss
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.nn.discriminator import NLayerDiscriminator as JaxDisc
from medvae_tpu.train import autobatch as jautobatch
from medvae_tpu.train import autoremat as jautoremat
from medvae_tpu.train import multistep as jmultistep
from medvae_tpu.train import optim as joptim
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu_torch.compat.jax_params import from_jax_disc_variables, from_jax_grads, from_jax_params
from medvae_tpu_torch.config.compose import compose
from medvae_tpu_torch.config.models import build_model, init_weights
from medvae_tpu_torch.data import medmnist as tmed
from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder
from medvae_tpu_torch.nn.discriminator import build_discriminator
from medvae_tpu_torch.nn.encoder_decoder import set_remat
from medvae_tpu_torch.train import autobatch as tautobatch
from medvae_tpu_torch.train import autoremat as tautoremat
from medvae_tpu_torch.train import multistep as tmultistep
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep
from medvae_tpu_torch.train.metrics import to_host
from medvae_tpu_torch.train.trainer import Trainer

BASE = dict(input_channels=1, latent_dim=4, hidden_channels=8, ch_mult=(1, 2), num_res_blocks=1,
            attn_resolutions=(), resolution=16)
DISC = dict(input_nc=3, ndf=8, n_layers=2)
VAE_LOSS = {"type": "vae", "kl_weight": 1e-3}
GAN_LOSS = {"type": "lpips_discriminator", "discriminator_factor": 0.5, "pixel_factor": 1.0,
            "kl_factor": 1e-3, "discriminator_iter_start": 2}
OPT = ({"type": "adam", "lr": 1e-3}, {"type": "constant"})
B = 8
TINY = ["model.hidden_channels=8", "model.ch_mult=[1,2]", "model.latent_dim=4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the models here are tiny, and under the test
    runner's parallel workers each worker's default of one thread a core
    oversubscribes the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    midx = rs.randint(0, 5, B).astype(np.int32)
    return {"image_u8": rs.randint(0, 256, (B, 16, 16, 1)).astype(np.uint8), "modality_idx": midx,
            "noise": rs.randn(B, 8, 8, 4).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ----------------------------------------------------------- chunk plan ---- #


@pytest.mark.parametrize("total, start, cadences, extra", [
    (640, 0, (50, 0), ()), (640, 213, (50, 100), (320,)), (17, 0, (1,), ()), (10, 3, (4, 6), (5, 9)),
    (1280, 640, (50, 0, 16), (960,)), (7, 7, (2,), ()), (100, 0, (-1, 0), (100,)),
])
def test_chunk_plan_is_jax_s(total, start, cadences, extra):
    want = jmultistep.chunk_plan(total, start, *cadences, extra=extra)
    assert tmultistep.chunk_plan(total, start, *cadences, extra=extra) == want


# ------------------------------------------- chunk runner vs the loop ---- #


def _split(n=40, size=16, seed=3):
    rs = np.random.RandomState(seed)
    return tmed.SplitArrays(images=rs.randint(0, 256, (n, size, size, 1)).astype(np.uint8),
                            labels=rs.randint(0, 9, n).astype(np.int32),
                            modality_idx=rs.randint(0, 5, n).astype(np.int32), channels=1)


def _run_state(loss, dropout=0.1):
    """(model, discriminator or None, state, train step) from fixed seeds."""
    model = init_weights(build_model(dict(BASE, dropout=dropout, _target_="BaseVAE"), "fp32", "cpu",
                                     train=True), seed=1)
    tx = toptim.build_optimizer(*OPT)
    disc = disc_tx = None
    if loss["type"] == "lpips_discriminator":
        disc = build_discriminator(DISC, "cpu", seed=2)
        disc_tx = toptim.discriminator_optimizer(*OPT)
    frozen = tstep.make_frozen(loss, "cpu", seed=0)
    state = tstate.create_train_state(model, tx, frozen, ema_decay=0.9, disc=disc, disc_tx=disc_tx)
    step = tstep.build_train_step(model, loss, tx, augment=True, max_channels=1, ema_decay=0.9,
                                  disc=disc, disc_tx=disc_tx, accumulate_grad_batches=2)
    return model, disc, state, step


def _tensors(state):
    out = {**state.params, **(state.ema_params or {})}
    if state.disc_params is not None:
        out.update({f"d.{k}": v for k, v in {**state.disc_params, **state.disc_batch_stats}.items()})
    return {k: v.detach().clone() for k, v in out.items()}


@pytest.mark.parametrize("loss", [VAE_LOSS, GAN_LOSS], ids=["plain", "gan"])
def test_chunk_runner_equals_the_per_step_loop(loss):
    """Five steps as chunks (2, 3) of the runner and as per-step calls, from
    the same state and seeds: every param, EMA and D tensor and the last
    metrics bit for bit (augmentation, dropout, two microbatches, and for the
    GAN its gate opening at step 2 inside the second chunk)."""
    feeder = DeviceCachedFeeder(_split(), B, "cpu", seed=5)
    seed_of = functools.partial(lambda s: 1000 + 7 * s)
    *_, loop_state, loop_step = _run_state(loss)
    gen = torch.Generator()
    perm = feeder.epoch_perm(1)
    for i in range(5):
        gen.manual_seed(seed_of(loop_state.step))
        loop_state, loop_metrics = loop_step(loop_state, feeder.assemble(perm, torch.tensor(i)), gen)
    *_, state, step = _run_state(loss)
    run = tmultistep.build_chunk_runner(step, feeder, torch.Generator(), seed_of)
    state, _ = run(state, 1, 0, 2)
    state, metrics = run(state, 1, 2, 3)
    assert state.step == loop_state.step == 5 and state.opt_state.count == 5
    want, got = _tensors(loop_state), _tensors(state)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert set(metrics) == set(loop_metrics)
    for k in metrics:
        assert torch.equal(metrics[k], loop_metrics[k]), k
    if loss is GAN_LOSS:
        assert float(metrics["train/d_weight"]) > 0.0


def test_eval_runner_equals_the_per_batch_loop():
    """The GAN eval step past its gate over a 37-row split (the last batch
    wrapped around): the runner's stacked metrics equal the per-batch loop's
    drawing from one generator in turn."""
    feeder = DeviceCachedFeeder(_split(n=37), B, "cpu", shuffle=False, drop_last=False)
    model, disc, state, _ = _run_state(GAN_LOSS)
    state.step = 3
    eval_step = tstep.build_eval_step(model, GAN_LOSS, max_channels=1, disc=disc)
    gen = torch.Generator().manual_seed(4)
    rows = [to_host(eval_step(state, batch, gen)) for batch in feeder.epoch(0)]
    run = tmultistep.build_eval_chunk_runner(eval_step, feeder, gen)
    gen.manual_seed(4)
    stacked = run(state, feeder.steps_per_epoch)
    assert len(rows) == feeder.steps_per_epoch == 5 and set(stacked) == set(rows[0])
    for k in stacked:
        assert np.array_equal(stacked[k].astype(np.float64), np.stack([r[k] for r in rows])), k
    assert float(stacked["val/_weight"][-1]) == 37 - 4 * B
    assert (stacked["val/d_loss"] != 0).all()


# -------------------------------------------- gradient accumulation ---- #


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    jm = JaxBaseVAE(**BASE)
    params = _np(jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                  jnp.zeros((2, 16, 16, 1)))["params"])
    jdisc = JaxDisc(**DISC)
    disc_vars = _np(jdisc.init(jax.random.PRNGKey(7), jnp.zeros((2, 16, 16, 3)), train=False))
    # jitted: the same values as the eager init, in a third of its time
    lpips = jax.jit(lambda key: JaxLPIPSLoss().init(key, 16))(jax.random.PRNGKey(11))
    npz = tmp_path_factory.mktemp("towers") / "lpips.npz"  # the flat `params/a/b` npz the graft reads
    np.savez(npz, **{"/".join(k.key for k in kp): np.asarray(v)
                     for kp, v in jax.tree_util.tree_flatten_with_path(lpips)[0]})
    return {"model": jm, "params": params, "disc": jdisc, "disc_vars": disc_vars,
            "frozen": {"lpips": lpips}, "npz": str(npz)}


def _adam_mu(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
               if isinstance(s, optax.ScaleByAdamState)]
    return _np(adam.mu)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "gan"])
def test_accumulated_step_matches_jax(jax_side, kind, k):
    loss = dict(GAN_LOSS, discriminator_iter_start=0) if kind == "gan" else VAE_LOSS
    gan = kind == "gan"
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jtx = joptim.build_optimizer(*OPT)
    jdtx = joptim.discriminator_optimizer(*OPT) if gan else None
    jtrain = jstep.build_train_step(jax_side["model"], loss, jtx, mesh, augment=False, max_channels=1,
                                    donate=False, accumulate_grad_batches=k,
                                    disc=jax_side["disc"] if gan else None, disc_tx=jdtx)
    frozen = jax_side["frozen"] if gan else {}
    jst = replicate(mesh, jstate.create_train_state(
        jax_side["params"], jtx, frozen=frozen, disc_variables=jax_side["disc_vars"] if gan else None,
        disc_tx=jdtx))
    batch = _batch()
    jst, jmetrics = jtrain(jst, shard_batch(mesh, batch), jax.random.PRNGKey(2))

    model = build_model(dict(BASE, _target_="BaseVAE"), "fp32", "cpu", train=True)
    model.load_state_dict(from_jax_params(jax_side["params"], model))
    tx = toptim.build_optimizer(*OPT)
    disc = disc_tx = None
    tfrozen = {}
    if gan:
        disc = build_discriminator(DISC, "cpu", seed=0)
        disc.load_state_dict(from_jax_disc_variables(jax_side["disc_vars"], disc))
        disc_tx = toptim.discriminator_optimizer(*OPT)
        tfrozen = tstep.make_frozen(dict(loss, weights_path=jax_side["npz"]), "cpu", seed=0)
    st = tstate.create_train_state(model, tx, tfrozen, disc=disc, disc_tx=disc_tx)
    step = tstep.build_train_step(model, loss, tx, max_channels=1, accumulate_grad_batches=k,
                                  disc=disc, disc_tx=disc_tx)
    st, metrics = step(st, _torch(batch))

    jm = {name: float(v) for name, v in jmetrics.items()}
    assert set(metrics) == set(jm)
    for name in sorted(jm):
        np.testing.assert_allclose(float(metrics[name]), jm[name], rtol=0 if name != "train/grad_norm" else 1e-3,
                                   atol=2e-4, err_msg=name)
    b1 = OPT[0].get("betas", (0.9, 0.999))[0]
    want = from_jax_grads(_adam_mu(jst.opt_state), model)
    got = dict(zip(st.params, st.opt_state.mu))
    for name in want:  # the first moment after one step is (1 - b1)·(clipped) gradient
        np.testing.assert_allclose(got[name].numpy() / (1 - b1), want[name].numpy() / (1 - b1), rtol=0,
                                   atol=5e-4, err_msg=name)
    if gan:
        want_d = from_jax_disc_variables({"params": _adam_mu(jst.disc_opt_state),
                                          "batch_stats": _np(jst.disc_batch_stats)}, disc)
        for name, mu in zip(st.disc_params, st.disc_opt_state.mu):
            np.testing.assert_allclose(mu.numpy() / 0.5, want_d[name].numpy() / 0.5, rtol=0, atol=5e-4,
                                       err_msg=name)
        for name, stat in st.disc_batch_stats.items():  # threaded through the k microbatches
            np.testing.assert_allclose(stat.numpy(), want_d[name].numpy(), rtol=0, atol=2e-4, err_msg=name)


# ------------------------------------------------------------- remat ---- #


@pytest.mark.parametrize("rung", ["block", "conv", "full", True])
def test_remat_rungs_equal_no_remat_with_dropout(rung):
    """Each rung recomputes its blocks in the backward pass; the dropout
    masks come from the step's own generator, which checkpointing does not
    restore, so they are taped: forward and gradients equal no remat bit for
    bit (a recompute that drew new masks misses by ~1e-2)."""
    cfg = dict(BASE, input_channels=3, attn_resolutions=(8,), dropout=0.1, _target_="BaseVAE")
    model = init_weights(build_model(cfg, "fp32", "cpu", train=True), seed=0)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))

    def run(r):
        set_remat(model, r)
        model.zero_grad(set_to_none=True)
        out = model(x, generator=torch.Generator().manual_seed(3))
        (out["reconstruction"].square().mean() + out["mean"].square().mean()).backward()
        return out["reconstruction"].detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    want, got = run(False), run(rung)
    assert torch.equal(got[0], want[0])
    for name in want[1]:
        assert torch.equal(got[1][name], want[1][name]), name
    with pytest.raises(ValueError, match="remat="):
        set_remat(model, "everything")


# ------------------------------------------------ probes, injected ---- #


@pytest.mark.parametrize("limit, start, cap, probes, multiple", [
    (100, 64, 65536, 16, 1), (1000, 64, 65536, 16, 8), (37, 64, 65536, 16, 1), (5000, 16, 300, 16, 1),
    (10**6, 64, 65536, 3, 1), (0, 64, 65536, 16, 1), (64, 64, 64, 16, 1), (700, 8, 65536, 5, 4),
])
def test_probe_max_batch_size_is_jax_s(limit, start, cap, probes, multiple):
    def trial(log):
        def try_fn(b):
            log.append(b)
            if b > limit:
                raise RuntimeError("CUDA out of memory. Tried to allocate")
        return try_fn

    results = []
    for mod in (jautobatch, tautobatch):
        log = []
        try:
            got = mod.probe_max_batch_size(trial(log), start=start, max_batch=cap, multiple=multiple,
                                           log=lambda _: None, max_probes=probes)
        except MemoryError as e:
            got = str(e)
        results.append((got, log))
    assert results[0] == results[1]
    assert tautobatch.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    with pytest.raises(ValueError):
        tautobatch.probe_max_batch_size(lambda b: (_ for _ in ()).throw(ValueError("not memory")),
                                        log=lambda _: None)


@pytest.mark.parametrize("peaks, budget, reserve, droppable", [
    ({False: 10, "block": 6}, 20, 0, False), ({False: 30, "block": 6}, 20, 0, False),
    ({False: 30, "block": 30}, 20, 0, False), ({False: 15, "block": 6}, 20, 8, True),
    ({False: 15, "block": 6}, 20, 8, False), ({False: None, "block": 6}, 20, 0, False),
    ({False: None, "block": 6}, 20, 4, True), ({False: 10, "block": 6}, None, 4, False),
    ({False: 10, "block": 6}, None, 4, True), ({False: "oom", "block": 6}, 20, 0, False),
    ({False: "fail", "block": "oom"}, 20, 0, False),
])
def test_choose_remat_is_jax_s(peaks, budget, reserve, droppable):
    gib = 2**30

    def probe(rung):
        p = peaks[rung]
        if p in ("oom", "fail"):
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory" if p == "oom" else "bad shape")
        return None if p is None else p * gib

    args = dict(budget=None if budget is None else budget * gib, reserve_bytes=reserve * gib,
                log=lambda _: None, droppable_reserve=droppable)
    assert tautoremat.choose_remat(probe, **args) == jautoremat.choose_remat(probe, **args)


def test_recorded_remat_decision_reads_what_jax_writes(tmp_path):
    for blob, want in (('{"remat_rung": "block", "device_cache_dropped": true}', ("block", True)),
                       ('{"remat_rung": false}', (False, False)), ('{"remat_rung": "conv"}', (None, False)),
                       ("not json", (None, False))):
        (tmp_path / "trainer_state.json").write_text(blob)
        assert tautoremat.recorded_remat_decision(str(tmp_path)) == want
        assert jautoremat.recorded_remat_decision(str(tmp_path)) == want
    assert tautoremat.recorded_remat_rung(str(tmp_path / "none")) is None


# ------------------------------------------------------------ trainer ---- #


def _cfg(config_dir, work, extra=(), epochs=2, limit=5):
    """The quick CVAE experiment on two of its five datasets (4,096 train
    and 512 validation rows), shrunk."""
    return compose(config_dir, "config", [
        "experiment=multi_modal_cvae_quick", f"work_dir={work}", "device=cpu",
        "data.dataset_names=[chestmnist,pathmnist]",
        f"training.max_epochs={epochs}", "training.log_every_n_steps=3", "early_stopping.enabled=false",
        "training.check_val_every_n_epoch=2", "training.val_check_interval=1.0",
        "data.batch_size=64", f"+training.limit_train_batches={limit}", "+data.device_cache=true",
        "training.log_images_every_n_epochs=0", *TINY, *extra,
    ])


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory, config_dir):
    t = Trainer(_cfg(config_dir, tmp_path_factory.mktemp("fused"), ["+training.fused_steps=on"]))
    val = t.fit()
    return t, val


def test_fused_trainer_equals_the_per_step_trainer(fused_run, tmp_path, config_dir):
    fused, fused_val = fused_run
    plain = Trainer(_cfg(config_dir, tmp_path, ["+training.fused_steps=off"]))
    plain_val = plain.fit()
    assert fused.state.step == plain.state.step == 10
    want, got = _params(plain), _params(fused)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    drop = "epoch_time_sec"
    assert {k: v for k, v in fused_val.items() if k != drop} == {k: v for k, v in plain_val.items() if k != drop}
    assert isinstance(fused._feeder("train", True, True), DeviceCachedFeeder)


def test_fused_resume_mid_plan_equals_the_uninterrupted_run(fused_run, tmp_path, config_dir):
    """Stopped after 3 of an epoch's 5 steps and resumed from `last`, the
    fused run starts its plan at step 3 and ends with the uninterrupted
    run's params."""
    Trainer(_cfg(config_dir, tmp_path, ["+training.fused_steps=on", "training.check_val_every_n_epoch=1"],
                 epochs=1, limit=3)).fit()  # its validation writes `last`
    resumed = Trainer(_cfg(config_dir, tmp_path, ["+training.fused_steps=on", "resume=true"]))
    assert resumed.state.step == 3
    resumed.fit()
    want, got = _params(fused_run[0]), _params(resumed)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_batch_size_auto_takes_the_cap_on_the_cpu(tmp_path, config_dir, capsys):
    t = Trainer(_cfg(config_dir, tmp_path, ["data.batch_size=auto", "+training.autobatch_start=16",
                                            "+training.autobatch_max=48", "+model.remat=auto"], epochs=1,
                     limit=2))
    assert t.datamodule.batch_size == 48 and t.steps_per_epoch == 4096 // 48
    out = capsys.readouterr().out
    assert "autobatch: 16 fits" in out and "autobatch: selected 48 (cap)" in out
    assert "probing is skipped under batch_size=auto" in out
    t.fit()
    assert t.state.step == 2


def test_remat_auto_is_recorded_and_reused_on_resume(tmp_path, config_dir, capsys):
    t = Trainer(_cfg(config_dir, tmp_path, ["+model.remat=auto"], epochs=1, limit=1))
    assert t._resolved_remat == "full"  # off the card: the fallback rung, unprobed
    assert tautoremat.recorded_remat_decision(t.ckpt.directory) == ("full", False)
    t.fit()
    capsys.readouterr()
    Trainer(_cfg(config_dir, tmp_path, ["+model.remat=auto", "resume=true"], epochs=2, limit=1))
    assert "resuming with recorded rung 'full'" in capsys.readouterr().out


def test_accumulation_refuses_the_disentangled_loss(tmp_path, config_dir):
    cfg = compose(config_dir, "config", [
        "experiment=disentangled_multi_modal_cvae_quick", f"work_dir={tmp_path}", "device=cpu",
        "+training.accumulate_grad_batches=2", *TINY])
    with pytest.raises(ValueError, match="allow_microbatched_disentangled"):
        Trainer(cfg)
