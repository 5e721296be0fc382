"""Entry point of the port (counterpart of __graft_entry__.entry,
__graft_entry__.py:16-46).

`entry()` returns `(fn, example_args)`: the training forward of the 28² quick
flagship DisentangledConditionalVAE (5 modalities, hidden 32, ch_mult 1-2-4,
one res block, no attention, latent 8 + 8), bf16, random weights from seed 0,
on the card unless `device` says otherwise.
`fn(params, x, modality_idx, noise) -> (reconstruction, mean, logvar)` runs
the model with `params` (a state_dict) through torch.func.functional_call;
`noise` is the reparameterization draw, where the JAX function takes a PRNG
key.

`dryrun_multichip(n, device="cuda")` is __graft_entry__.dryrun_multichip
(:49-): n ranks on the card (one rank runs in this process, in a one-rank
NCCL group; more are spawned, parallel/launch.py, under NCCL when each has
a card of its own and under gloo when they share one), or with
`device="cpu"` n gloo ranks on the CPU, run one step each of the
data-parallel step of the 28² flagship, DP×TP when n ≥ 4 and even, the GAN
step with sync-BN and the global d_weight, a fused 3-step chunk over the
stratified device cache (under NCCL a captured graph; held bit for bit to
the per-step calls) and the full loss surface (ELBO + LPIPS + CLIP), and
print JAX's five `ok` lines with their losses.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from medvae_tpu_torch.config.models import build_model, init_weights

ENTRY_MODEL: Dict[str, Any] = {
    "_target_": "medvae_tpu.models.DisentangledConditionalVAE",
    "num_modalities": 5,
    "shared_latent_dim": 8,
    "modality_latent_dim": 8,
    "hidden_channels": 32,
    "ch_mult": [1, 2, 4],
    "num_res_blocks": 1,
    "attn_resolutions": [],
    "dropout": 0.0,
    "resolution": 28,
}


def entry(device: Any = "cuda") -> Tuple[Callable, tuple]:
    """(fn, (params, x, modality_idx, noise)) with an (8, 28, 28, 3) bf16
    zero image, modalities [0, 1, 2, 3, 4, 0, 1, 2] and standard-normal
    (8, 7, 7, 16) noise from numpy seed 0."""
    model = init_weights(build_model(ENTRY_MODEL, "bf16", device), seed=0)
    params = dict(model.state_dict())
    x = torch.zeros((8, 28, 28, 3), dtype=torch.bfloat16, device=device)
    midx = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2], dtype=torch.int32, device=device)
    r, zdim = model.encoder_out_res, model.total_latent_dim
    noise = torch.from_numpy(np.random.RandomState(0).randn(8, r, r, zdim).astype(np.float32))

    def fn(params, x, midx, noise):
        out = torch.func.functional_call(model, params, (x, midx), {"noise": noise.to(x.device)})
        return out["reconstruction"], out["mean"], out["logvar"]

    return fn, (params, x, midx, noise.to(device))


DISENTANGLED_LOSS: Dict[str, Any] = {
    "type": "disentangled_vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0,
    "separation_weight": 0.1, "contrastive_weight": 0.05,
}
GAN_LOSS: Dict[str, Any] = {
    "type": "lpips_discriminator", "discriminator_factor": 0.5, "perceptual_factor": 1.0,
    "kl_factor": 1e-4, "discriminator_iter_start": 0,  # gate open: both optimizers move
}
TINY_16 = dict(hidden_channels=8, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=16)
# the dry run's GAN generator (fp32) and its tiny flagship (bf16) of the
# fused chunk and the full loss surface
GAN_CVAE: Dict[str, Any] = dict(TINY_16, _target_="medvae_tpu.models.ConditionalVAE", input_channels=3,
                                latent_dim=4, condition_method="concat")
GAN_DISC: Dict[str, Any] = {"input_nc": 3, "ndf": 8, "n_layers": 2}
TINY_FLAGSHIP: Dict[str, Any] = dict(TINY_16, _target_="medvae_tpu.models.DisentangledConditionalVAE",
                                     num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, dropout=0.0)
CHUNK_STEPS = 3  # the fused chunk's steps, run fused and then per step


def _host_batch(b: int, size: int, seed: int, channels_by_modality: bool) -> Dict[str, np.ndarray]:
    midx = (np.arange(b) % 5).astype(np.int32)
    return {
        "image_u8": np.random.RandomState(seed).randint(0, 255, (b, size, size, 3), np.uint8),
        "label": np.zeros((b,), np.int32),
        "modality_onehot": np.eye(12, dtype=np.float32)[midx],
        "modality_idx": midx,
        "channels": (np.asarray([1, 3, 3, 1, 3], np.int32)[midx] if channels_by_modality
                     else np.full((b,), 3, np.int32)),
        "valid": np.ones((b,), np.float32),
    }


def _dryrun_rank(rank: int, n: int) -> List[str]:
    """The dry run on this rank (the default group started); returns the
    `ok` lines."""
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.data.medmnist import SplitArrays
    from medvae_tpu_torch.data.pipeline import DeviceCachedFeeder
    from medvae_tpu_torch.nn.discriminator import build_discriminator
    from medvae_tpu_torch.parallel import shard_map_step as sms
    from medvae_tpu_torch.parallel import tensor_parallel as tp
    from medvae_tpu_torch.train.multistep import build_chunk_runner
    from medvae_tpu_torch.train.optim import build_optimizer
    from medvae_tpu_torch.train.state import create_train_state
    from medvae_tpu_torch.train.step import build_train_step, make_frozen

    dist = core_mesh.current()
    device = dist.device
    mesh = core_mesh.create_mesh(core_mesh.MeshSpec(data=n, model=1), dist)
    tx = build_optimizer({"type": "adam", "lr": 1e-3}, {"type": "constant"})
    b = 2 * n
    lines: List[str] = []

    def local(batch: Dict[str, np.ndarray], m) -> Dict[str, torch.Tensor]:
        rows = m.local_rows(b)
        return {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}

    def gen(step: int, m) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(sms.rank_seed(0, step, m))

    def finite(*values: float) -> None:
        if not all(np.isfinite(v) for v in values):
            raise FloatingPointError(f"dryrun_multichip({n}): non-finite losses {values}")

    # the shard_map DP step of the 28² flagship
    model = init_weights(build_model(ENTRY_MODEL, "bf16", device, train=True), seed=0)
    host_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, tx)
    step = sms.build_shard_map_train_step(model, DISENTANGLED_LOSS, tx, mesh, max_channels=3)
    flag_batch = _host_batch(b, 28, 0, True)
    _, metrics = step(state, local(flag_batch, mesh), gen(0, mesh))
    loss = float(metrics["train/loss"])
    finite(loss)
    lines.append(f"dryrun_multichip({n}) shard_map DP: ok, loss={loss:.4f}")

    # DP × TP: convs and denses sharded over model = 2
    if n >= 4 and n % 2 == 0:
        mesh2 = core_mesh.create_mesh(core_mesh.MeshSpec(data=n // 2, model=2), dist)
        model2 = build_model(ENTRY_MODEL, "bf16", device, train=True)
        model2.load_state_dict(host_params)
        tp.shard_model(model2, mesh2)
        layout = tp.ShardLayout([model2])
        state2 = create_train_state(model2, tx)
        params2 = list(state2.params.values())
        step2 = sms.build_dp_train_step(model2, DISENTANGLED_LOSS, tp.with_tp_norm(tx, params2, layout), mesh2,
                                        max_channels=3)
        rows = mesh2.local_rows(b)
        _, metrics2 = step2(state2, {k: torch.from_numpy(v[rows]).to(device) for k, v in flag_batch.items()},
                            gen(0, mesh2))
        loss2 = float(metrics2["train/loss"])
        finite(loss2)
        lines.append(f"dryrun_multichip({n}) jit DP{n // 2}xTP2: ok, loss={loss2:.4f}")

    # the GAN step: dual optimizers, sync-BN discriminator, global d_weight
    cvae = init_weights(build_model(GAN_CVAE, "fp32", device, train=True), seed=0)
    disc = build_discriminator(GAN_DISC, device, seed=1)
    gan_state = create_train_state(cvae, tx, make_frozen(GAN_LOSS, device, seed=0), disc=disc, disc_tx=tx)
    gan_step = sms.build_shard_map_gan_step(cvae, GAN_LOSS, tx, mesh, disc, tx, max_channels=3)
    gan_batch = _host_batch(b, 16, 1, False)
    _, gm = gan_step(gan_state, local(gan_batch, mesh), gen(0, mesh))
    g_loss, d_loss = float(gm["train/total_loss"]), float(gm["train/d_loss"])
    finite(g_loss, d_loss)
    lines.append(f"dryrun_multichip({n}) shard_map GAN (sync-BN, global d_weight): ok, "
                 f"g_loss={g_loss:.4f}, d_loss={d_loss:.4f}")

    # a fused 3-step chunk over the stratified device cache, held to the
    # per-step calls bit for bit
    n_rows = 4 * b
    arrays = SplitArrays(images=np.random.RandomState(2).randint(0, 255, (n_rows, 16, 16, 3), np.uint8),
                         labels=np.zeros((n_rows,), np.int32),
                         modality_idx=np.asarray(np.arange(n_rows) % 5, np.int32), channels=3)
    feeder = DeviceCachedFeeder(arrays, b, device, shuffle=True, drop_last=True, stratify=True, mesh=mesh)
    runs = []
    for fused in (True, False):
        tiny = init_weights(build_model(TINY_FLAGSHIP, "bf16", device, train=True), seed=0)
        fstate = create_train_state(tiny, tx)
        fstep = sms.build_shard_map_train_step(tiny, DISENTANGLED_LOSS, tx, mesh, max_channels=3)
        generator = torch.Generator(device=device)
        if fused:
            runner = build_chunk_runner(fstep, feeder, generator, lambda s: sms.rank_seed(0, s, mesh),
                                        capture=device.type == "cuda" and dist.backend == "nccl")
            fstate, fmetrics = runner(fstate, 0, 0, CHUNK_STEPS)
        else:
            perm = feeder.epoch_perm(0)
            for i in range(CHUNK_STEPS):
                generator.manual_seed(sms.rank_seed(0, fstate.step, mesh))
                fstate, fmetrics = fstep(fstate, feeder.assemble(perm, torch.tensor(i, device=device)), generator)
        if fstate.step != CHUNK_STEPS:
            raise RuntimeError(f"dryrun_multichip({n}): the fused chunk took {fstate.step} steps, not {CHUNK_STEPS}")
        runs.append(({k: v.detach().clone() for k, v in fstate.params.items()}, float(fmetrics["train/loss"])))
    same = runs[0][1] == runs[1][1] and all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
    if not same:
        raise RuntimeError(f"dryrun_multichip({n}): the fused chunk differs from the per-step calls")
    f_loss = runs[0][1]
    finite(f_loss)
    where = "captured" if device.type == "cuda" and dist.backend == "nccl" else "a loop"
    lines.append(f"dryrun_multichip({n}) fused 3-step chunk (stratified device cache, {where}, bit for bit "
                 f"the per-step calls): ok, loss={f_loss:.4f}")

    # the full flagship loss surface: disentangled ELBO + LPIPS + CLIP
    full_cfg = dict(DISENTANGLED_LOSS, perceptual_weight=0.1, biomedclip_weight=0.1, clip_encoder="simple")
    tiny = init_weights(build_model(TINY_FLAGSHIP, "bf16", device, train=True), seed=0)
    full_state = create_train_state(tiny, tx, make_frozen(full_cfg, device, seed=0))
    full_step = sms.build_shard_map_train_step(tiny, full_cfg, tx, mesh, max_channels=3)
    _, fm = full_step(full_state, local(gan_batch, mesh), gen(0, mesh))
    fl, pl, cl = float(fm["train/loss"]), float(fm["train/p_loss"]), float(fm["train/bc_loss"])
    finite(fl, pl, cl)
    lines.append(f"dryrun_multichip({n}) full-flagship loss surface (ELBO+LPIPS+CLIP): ok, loss={fl:.4f}, "
                 f"lpips={pl:.4f}, clip={cl:.4f}")
    return lines


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> List[str]:
    """The multi-device dry run (module docstring): n ranks on the card, or
    with `device="cpu"` n gloo ranks on the CPU. Raises when the card is
    asked for and missing. Prints and returns rank 0's five `ok` lines
    (four when n < 4 or odd)."""
    from medvae_tpu_torch.core import mesh as core_mesh

    on_card = str(device).startswith("cuda")
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip asks for the card and there is no CUDA device; pass device='cpu'")
    with tempfile.TemporaryDirectory(prefix="medvae_dryrun_") as store:
        if on_card and n_devices == 1:
            core_mesh.init_distributed("cuda", init_method=f"file://{os.path.join(store, 'store')}", rank=0,
                                       world_size=1)
            try:
                lines = _dryrun_rank(0, 1)
            finally:
                core_mesh.shutdown()
        else:
            from medvae_tpu_torch.parallel.launch import spawn

            lines = spawn(_dryrun_rank, n_devices, store_dir=store, args=(n_devices,), timeout=timeout,
                          device="cuda" if on_card else "cpu")[0]
    for line in lines:
        print(line, flush=True)
    return lines
