"""The reference side of each cell's comparison: the plain model, its towers,
discriminator and optimizers built from a configuration file, with the
weights the benchmark makes from the seed (portbench/weights.py), and the
readings that the comparison holds the program's against.

Everything here is the benchmark's own: it imports nothing of the program
and takes nothing the program made. The inputs (rows of the synthetic
splits, noise, augmentation draws) are the benchmark's, made from the seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from portbench import weights
from portbench.common import sub_seed
from portbench.reference import model as ref_model
from portbench.reference.discriminator import NLayerDiscriminator
from portbench.reference.operands import configure_backends, operand_format
from portbench.reference.optim import build_optimizer, discriminator_optimizer
from portbench.reference.state import create_train_state
from portbench.reference.step import _tower_plan, build_train_step

# the streams of a run's --seed (common.sub_seed)
MODEL_STREAM, DATA_STREAM, DISC_STREAM, TOWER_STREAM, NOISE_STREAM = 1, 2, 5, 10, 1000


def loss_cfg_of(cfg: Dict[str, Any]) -> Dict[str, Any]:
    loss = dict(cfg["loss"])
    if "discriminator" in cfg:
        loss["discriminator"] = dict(cfg["discriminator"])
    return loss


def model_spec(cfg: Dict[str, Any]):
    return weights.spec(ref_model.build(cfg["model"], "meta"))


def tower_specs(cfg: Dict[str, Any]) -> Dict[str, list]:
    """{tower key: weight spec} of the frozen towers the loss needs."""
    out = {}
    for key, (_, loss) in _tower_plan(loss_cfg_of(cfg)).items():
        with torch.device("meta"):
            out[key] = weights.spec(_tower_class(loss)())
    return out


def _tower_class(loss):
    from portbench.reference.clip_vit import CLIPViT
    from portbench.reference.perceptual import LPIPSNet, SimpleCLIPEncoder

    if hasattr(loss, "encoder"):
        return CLIPViT if loss.encoder == "vit" else SimpleCLIPEncoder
    return LPIPSNet


def disc_spec(cfg: Dict[str, Any]):
    d = cfg["discriminator"]
    with torch.device("meta"):
        return weights.spec(NLayerDiscriminator(int(d.get("input_nc", 3)), int(d.get("ndf", 64)),
                                                int(d.get("n_layers", 3))))


def tower_seed(seed: int, key: str) -> int:
    return sub_seed(seed, TOWER_STREAM + sorted(["clip", "lpips"]).index(key))


def noise_shape(cfg: Dict[str, Any], batch: int) -> tuple:
    m = ref_model.build(cfg["model"], "meta")
    res = int(m.resolution) // 2 ** (len(tuple(m.ch_mult)) - 1)
    return (batch, res, res, int(m.latent_dim))


def step_inputs(shape: tuple, seed: int, step: int, device, augment: bool):
    """The reparameterization noise (NHWC, `shape`) and augmentation draws
    of train step `step`, drawn from the step's own seed on the device: the
    benchmark hands the same to the program and to the reference."""
    batch = shape[0]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, NOISE_STREAM + step))
    noise = torch.randn(shape, generator=gen, device=device)
    draws = None
    if augment:
        u = torch.rand((4, batch), generator=gen, device=device)
        draws = {"flip": u[0] < 0.5, "angle": -10.0 + 20.0 * u[1],
                 "brightness": 0.9 + 0.2 * u[2], "contrast": 0.9 + 0.2 * u[3]}
    return noise, draws


class TrainReference:
    """The reference's train step of a configuration, fp32 (TF32 off), or
    with fp8 operands (`fmt`), from the seed's weights."""

    def __init__(self, cfg: Dict[str, Any], seed: int, device, steps_per_epoch: int, fmt: str = "fp32",
                 remat: Any = "block"):
        configure_backends()
        self.cfg, self.fmt = cfg, fmt
        loss_cfg = loss_cfg_of(cfg)
        meta = torch.device(device).type == "meta"  # shapes alone: no weights to make
        self.model = ref_model.build(cfg["model"], device, train=True, remat=remat)
        if not meta:
            weights.load(self.model, weights.make(model_spec(cfg), sub_seed(seed, MODEL_STREAM), device))
        frozen = {}
        for key, (_, loss) in _tower_plan(loss_cfg).items():
            with torch.device(device):
                net = _tower_class(loss)()
            if not meta:
                weights.load(net, weights.make(weights.spec(net), tower_seed(seed, key), device))
            frozen[key] = net.requires_grad_(False)
        opt = (dict(cfg["optimizer"]), dict(cfg.get("scheduler") or {}))
        kw = dict(steps_per_epoch=steps_per_epoch, gradient_clip_val=cfg.get("gradient_clip_val", 1.0))
        self.tx = build_optimizer(*opt, **kw)
        self.disc = self.disc_tx = disc_tx = None
        if "discriminator" in cfg:
            d = cfg["discriminator"]
            with torch.device(device):
                self.disc = NLayerDiscriminator(int(d.get("input_nc", 3)), int(d.get("ndf", 64)),
                                                int(d.get("n_layers", 3)))
            if not meta:
                weights.load(self.disc, weights.make(disc_spec(cfg), sub_seed(seed, DISC_STREAM), device))
            disc_tx = self.disc_tx = discriminator_optimizer(*opt, **kw)
        self.state = create_train_state(self.model, self.tx, frozen, disc=self.disc, disc_tx=disc_tx)
        self.state.step = int(cfg.get("start_step", 0))
        self.step = build_train_step(self.model, loss_cfg, self.tx, augment=bool(cfg["data"]["augment_train"]),
                                     max_channels=int(cfg["data"]["max_channels"]), disc=self.disc,
                                     disc_tx=disc_tx)

    def run(self, batch, draws) -> Dict[str, float]:
        with operand_format(self.fmt):
            self.state, metrics = self.step(self.state, batch, None, draws)
        return {k: float(v) for k, v in metrics.items()}


def leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """{name: ‖t‖ · scale} in fp64, read in one copy."""
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu().tolist()
    return {n: v * scale for n, v in zip(names, norms)}


def _change_norms(params: Dict[str, torch.Tensor], initial: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: ‖p − initial‖}, one leaf's difference at a time."""
    names = list(params)
    norms = torch.stack([(params[n].detach().float() - initial[n]).double().norm() for n in names])
    return dict(zip(names, norms.cpu().tolist()))


def first_grad_norms(state, tx, disc_tx=None) -> Dict[str, float]:
    """Each leaf's norm of the first gradient as the optimizer got it (after
    clipping), read from its first moment after one update: m = (1 − b1) g."""
    out = leaf_norms(dict(zip(state.params, state.opt_state.mu)), 1.0 / (1.0 - tx.b1))
    if disc_tx is not None and state.disc_params is not None:
        out.update({f"disc.{k}": v for k, v in
                    leaf_norms(dict(zip(state.disc_params, state.disc_opt_state.mu)), 1.0 / (1.0 - disc_tx.b1)).items()})
    return out


def change_norms(state, initial: Dict[str, torch.Tensor], disc_initial: Optional[Dict[str, torch.Tensor]] = None):
    """Each leaf's norm of its change from `initial`."""
    out = _change_norms(state.params, initial)
    if disc_initial is not None and state.disc_params is not None:
        out.update({f"disc.{k}": v for k, v in _change_norms(state.disc_params, disc_initial).items()})
    return out


def train_readings(cfg: Dict[str, Any], seed: int, batches: List[Dict[str, torch.Tensor]], device,
                   steps_per_epoch: int, fmt: str = "fp32", loss_keys=("train/loss",)) -> Dict[str, Any]:
    """The reference's readings over `batches` (one per step, each with its
    `noise` and `draws`): each step's losses, the first gradient's leaf
    norms, and the leaf norms of the params' change after the last step."""
    ref = TrainReference(cfg, seed, device, steps_per_epoch, fmt)
    init = weights.make(model_spec(cfg), sub_seed(seed, MODEL_STREAM), device)
    dinit = weights.make(disc_spec(cfg), sub_seed(seed, DISC_STREAM), device) if ref.disc is not None else None
    losses, grads = [], None
    for i, b in enumerate(batches):
        metrics = ref.run({k: v for k, v in b.items() if k != "draws"}, b.get("draws"))
        losses.append({k: metrics[k] for k in loss_keys})
        if i == 0:
            grads = first_grad_norms(ref.state, ref.tx, ref.disc_tx)
    return {"losses": losses, "grads": grads, "changes": change_norms(ref.state, init, dinit)}


def train_step_flops(cfg: Dict[str, Any], batch: int) -> float:
    """FLOPs of one reference train step at the cell's shapes, counted on the
    meta device without rematerialization: convolutions, matmuls and
    attention of the forward, the towers, the discriminator and the
    backward, whatever implements them in the program."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.modalities import MODALITY_NAMES

    ref = TrainReference(cfg, 0, "meta", 1, remat=False)
    size, m = int(cfg["data"]["size"]), torch.device("meta")
    midx = torch.zeros((batch,), dtype=torch.int64, device=m)
    b = {"image_u8": torch.zeros((batch, size, size, 3), dtype=torch.uint8, device=m), "modality_idx": midx,
         "modality_onehot": torch.zeros((batch, len(MODALITY_NAMES)), device=m),
         "channels": torch.full((batch,), 3, device=m), "noise": torch.zeros(noise_shape(cfg, batch), device=m)}
    draws = None
    if bool(cfg["data"]["augment_train"]):
        z = torch.zeros((batch,), device=m)
        draws = {"flip": z < 0.5, "angle": z, "brightness": z + 1.0, "contrast": z + 1.0}
    with FlopCounterMode(display=False) as counter:
        ref.step(ref.state, b, None, draws)
    return float(counter.get_total_flops())


def forward_flops(cfg: Dict[str, Any], batch: int) -> float:
    """FLOPs of one reference reconstruct (posterior mean, decode) of
    `batch` images, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ref_model.build(cfg["model"], "meta", train=False)
    size, m = int(cfg["data"]["size"]), torch.device("meta")
    x = torch.zeros((batch, size, size, int(getattr(model, "max_channels", 3) or 3)), device=m)
    midx = torch.zeros((batch,), dtype=torch.int64, device=m)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        _reconstruct(model, x, midx)
    return float(counter.get_total_flops())


def _reconstruct(model, x, midx):
    """The serving graph: encode to the posterior mean, decode (the flagship
    routes both by modality; the ConditionalVAE takes the one-hot)."""
    from portbench.reference.conditional_vae import ConditionalVAE
    from portbench.reference.disentangled_conditional_vae import DisentangledConditionalVAE

    if isinstance(model, DisentangledConditionalVAE):
        mean, _ = model.encode(x, midx)
        return model.decode(mean, midx)
    if isinstance(model, ConditionalVAE):
        mean, _ = model.encode(x, torch.nn.functional.one_hot(midx, int(model.cond_dim)).float())
        return model.decode(mean)
    mean, _ = model.encode(x)
    return model.decode(mean)
