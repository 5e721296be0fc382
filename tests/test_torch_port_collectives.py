"""`parallel/collectives.py:pmean` keeps each tensor's memory layout, and so
the data-parallel step in a one-rank group is the plain step bit for bit.

The fault this holds fixed: pmean'd gradients came back as views of one
flat buffer, so a channels-last conv weight's gradient lost its strides and
the gradient norm summed it in another order; the one-rank DP step's
`train/grad_norm` parted from the plain step's in the last bit. Here the
model is made channels-last, so autograd hands its conv weights' gradients
back channels-last, as cuDNN does on the card.

One gloo rank (parallel/launch.py: a `file://` store under tmp_path, joined
within a timeout).
"""

import numpy as np
import pytest
import torch

from medvae_tpu_torch.parallel.launch import spawn

RANK_TIMEOUT = 240
STEPS = 3
FLAG = dict(num_modalities=5, shared_latent_dim=4, modality_latent_dim=4, hidden_channels=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(), resolution=16)
LOSS = {"type": "disentangled_vae"}
SGD = ({"type": "sgd", "lr": 1e-2, "momentum": 0.0}, None)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(n=4, size=16, seed=0):
    rs = np.random.RandomState(seed)
    midx = (np.arange(n) % 5).astype(np.int32)
    return {
        "image_u8": torch.from_numpy(rs.randint(0, 255, (n, size, size, 3), np.uint8)),
        "label": torch.zeros((n,), dtype=torch.int32),
        "modality_onehot": torch.from_numpy(np.eye(12, dtype=np.float32)[midx]),
        "modality_idx": torch.from_numpy(midx),
        "channels": torch.from_numpy(np.asarray([1, 3, 3, 1, 3], np.int32)[midx]),
        "valid": torch.ones((n,)),
        "noise": torch.from_numpy(rs.randn(n, 8, 8, 8).astype(np.float32)),
    }


def _rank(rank: int) -> dict:
    from medvae_tpu_torch.config.models import build_model, init_weights
    from medvae_tpu_torch.core import mesh as core_mesh
    from medvae_tpu_torch.parallel.collectives import pmean
    from medvae_tpu_torch.parallel.shard_map_step import build_shard_map_train_step
    from medvae_tpu_torch.train.optim import build_optimizer
    from medvae_tpu_torch.train.state import create_train_state
    from medvae_tpu_torch.train.step import build_train_step

    mesh = core_mesh.create_mesh(core_mesh.MeshSpec(data=1), core_mesh.current())
    group = mesh.group("batch")
    conv = torch.nn.Conv2d(3, 8, 3).to(memory_format=torch.channels_last)
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0))
    conv(x.to(memory_format=torch.channels_last)).square().sum().backward()
    grads = [conv.weight.grad, conv.bias.grad]
    reduced = pmean(grads, group)
    out = {"group": group is not None,
           "strides": [(g.stride(), r.stride()) for g, r in zip(grads, reduced)],
           "values_equal": all(torch.equal(g, r) for g, r in zip(grads, reduced)),
           "norms": {}}
    batch = _batch()
    for kind in ("plain", "dp"):
        model = build_model(dict(FLAG, _target_="medvae_tpu.models.DisentangledConditionalVAE"), "fp32", "cpu",
                            train=True)
        init_weights(model, seed=0)
        model.to(memory_format=torch.channels_last)
        tx = build_optimizer(*SGD)
        state = create_train_state(model, tx)
        step = (build_train_step(model, LOSS, tx, max_channels=3) if kind == "plain"
                else build_shard_map_train_step(model, LOSS, tx, mesh, max_channels=3))
        norms = []
        for _ in range(STEPS):
            state, metrics = step(state, batch)
            norms.append(float(metrics["train/grad_norm"]))
        out["norms"][kind] = norms
    return out


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    (result,) = spawn(_rank, 1, store_dir=str(tmp_path_factory.mktemp("pmean")), timeout=RANK_TIMEOUT)
    return result


def test_pmean_returns_each_tensor_in_its_inputs_strides(one_rank):
    assert one_rank["group"], "a one-rank gloo group was started, so pmean reduces through it"
    weight, bias = one_rank["strides"]
    assert weight[0] != torch.empty(8, 3, 3, 3).stride(), "the conv weight's gradient is channels-last"
    assert weight[0] == weight[1] and bias[0] == bias[1]
    assert one_rank["values_equal"]


def test_one_rank_dp_steps_grad_norm_is_the_plain_steps_bit_for_bit(one_rank):
    assert one_rank["norms"]["dp"] == one_rank["norms"]["plain"]
