"""The port's whole-sequence attention (kernels B4 and B5) on the CPU.

On the CPU the wrappers take their plain PyTorch versions, so these hold the
plain versions, the functions the CUDA kernels are held to on the card,
against the JAX package's Pallas kernels run as tests/test_ops.py runs them:
in Pallas interpret mode with the backend gate opened. Inputs come from numpy
seeds. Tolerances: B4 1e-5 and B5 1e-4, the JAX package's own bars
(tests/test_ops.py:40,59); bf16 outputs one bf16 ulp (2^-7 relative)
beyond that, since two fp32 results 1e-7 apart may round to neighbouring
bf16 values. A small BaseVAE with 16² × 64 attention (n 256, c 64, inside
the envelope) runs through B4/B5's route in both packages: forward 2e-4,
three train steps' losses 2e-4 and step-1 gradients 5e-4.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from medvae_tpu.core.mesh import replicate, shard_batch
from medvae_tpu.models import BaseVAE as JaxBaseVAE
from medvae_tpu.ops import attention as jattn
from medvae_tpu.ops import flash_attention as jfa
from medvae_tpu.train import optim as joptim
from medvae_tpu.train import state as jstate
from medvae_tpu.train import step as jstep
from medvae_tpu_torch.compat.jax_params import from_jax_grads, from_jax_params
from medvae_tpu_torch.config.models import build_model
from medvae_tpu_torch.ops import attention as at
from medvae_tpu_torch.train import optim as toptim
from medvae_tpu_torch.train import state as tstate
from medvae_tpu_torch.train import step as tstep

SHAPES = [(2, 16, 32), (1, 8, 16), (2, 128, 64), (1, 144, 96)]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode, gates open."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def _arrays(seed, shape, count):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(count)]


def _as(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays]


def _assert_close(got, want, atol, dtype):
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    rounding = 2.0**-7 * np.abs(want) if dtype == "bf16" else 0.0
    assert np.all(np.abs(got - want) <= atol + rounding), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_b4_plain_version_matches_the_jax_kernel(interpret, shape, dtype):
    (jq, jk, jv), (tq, tk, tv) = _as(_arrays(0, shape, 3), dtype)
    want = jattn._attention_fwd_kernel(jq, jk, jv)
    got = at.fused_attention_fwd_plain(tq, tk, tv)
    assert got.dtype == DTYPES[dtype][1]
    _assert_close(got, want, 1e-5, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_b5_plain_version_matches_the_jax_kernel(interpret, shape, dtype):
    jargs, targs = _as(_arrays(1, shape, 4), dtype)
    want = jattn._attention_bwd_kernel(*jargs)
    got = at.fused_attention_bwd_plain(*targs)
    for g, w in zip(got, want):
        _assert_close(g, w, 1e-4, dtype)


NS = [49, 127, 128, 144, 196, 256, 784, 863, 864, 1024, 3136]
CS = [32, 63, 64, 96, 512, 1024, 2870, 2871]


@pytest.mark.parametrize("n", NS)
def test_gates_match_the_jax_dispatch(n, monkeypatch):
    """uses_fused equals JAX's whole-sequence gate everywhere on the grid
    (the (863, 64) and (128, 2870) corners of the 10 MiB budget included);
    uses_flash equals JAX's flash route except where JAX's VMEM estimate
    refuses, the documented difference."""
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(jfa, "_on_tpu", lambda: True)
    monkeypatch.setattr(jattn, "fused_attention", lambda q, k, v: "fused")
    monkeypatch.setattr(jfa, "flash_attention", lambda q, k, v: "flash")
    for c in CS:
        q = jax.ShapeDtypeStruct((1, n, c), jnp.bfloat16)
        want = jattn.fused_attention_or_none(q, q, q)
        got = "fused" if at.uses_fused(n, c) else "flash" if at.uses_flash(n, c) else None
        if got != want:
            assert (got, want) == ("flash", None), (n, c, got, want)
            assert jfa._flash_vmem_estimate(n, c, 2) > jfa._FLASH_VMEM_BUDGET, (n, c)
        assert at.uses_fused(n, c) == (n >= 128 and c >= 64 and jattn._vmem_estimate(n, c) <= 10 << 20)
    assert at.uses_fused(863, 64) and not at.uses_fused(864, 64)
    assert at.uses_fused(128, 2870) and not at.uses_fused(128, 2871)


def test_attention_routes_the_envelope_to_b4_and_counts_no_launch_on_the_cpu(monkeypatch):
    q, k, v = map(torch.from_numpy, _arrays(2, (2, 256, 64), 3))
    before = dict(at.launches)
    torch.testing.assert_close(at.attention(q, k, v), at.fused_attention_fwd_plain(q, k, v),
                               rtol=0, atol=0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = at.attention(*leaves)
    assert out.grad_fn is not None and "FusedAttention" in type(out.grad_fn).__name__
    assert at.launches == before  # only kernel launches count


@pytest.mark.parametrize("shape", [(2, 144, 96), (1, 128, 64)])
def test_function_grads_match_autograd_of_the_plain_forward(shape):
    q, k, v, w = map(torch.from_numpy, _arrays(3, shape, 4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad((at.FusedAttention.apply(*leaves) * w).sum(), leaves)
    want = torch.autograd.grad((at.fused_attention_fwd_plain(*ref) * w).sum(), ref)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)



def _bf16_terms(x: torch.Tensor, terms: int):
    """x = t0 + t1 + ... with t_i = bf16(x - t0 - ... - t_{i-1}), each term
    widened back to fp32 (csrc/hopper.cuh: split3)."""
    out, rest = [], x
    for _ in range(terms):
        t = rest.bfloat16().float()
        out.append(t)
        rest = rest - t
    return out


def test_three_bf16_terms_keep_fp32_fidelity_of_products_with_p():
    """The Hopper instance's premise: P (fp32 softmax rows) times a
    bf16-valued operand, as three bf16-term products summed in fp32, is as
    close to the fp64 product as the fp32 product is; one term alone is not
    (rounding P once to bf16 misses by ~1e-3)."""
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(64, 256).astype(np.float32)) * 2.0
    p = torch.softmax(logits, dim=-1)
    v = torch.from_numpy(rs.randn(256, 1024).astype(np.float32)).bfloat16().float()
    exact = p.double() @ v.double()

    def rel(got):
        return float(torch.linalg.vector_norm(got.double() - exact) / torch.linalg.vector_norm(exact))

    fp32 = rel(p @ v)
    three = rel(sum(t @ v for t in _bf16_terms(p, 3)))
    assert three <= 1e-6 and fp32 <= 1e-6, (three, fp32)
    assert rel(_bf16_terms(p, 1)[0] @ v) >= 1e-4

def test_function_passes_gradcheck_in_float64():
    q, k, v = (torch.from_numpy(a).double().requires_grad_(True)
               for a in _arrays(4, (2, 20, 12), 3))
    assert torch.autograd.gradcheck(at.FusedAttention.apply, (q, k, v))


# ------------------------------------------------ a BaseVAE on B4's route ---- #

SMALL = dict(input_channels=3, latent_dim=4, hidden_channels=32, ch_mult=(1, 2),
             num_res_blocks=1, attn_resolutions=(16,), resolution=32)
SITES = 5  # encoder level 1, encoder mid, decoder mid, decoder level 1 (two)
B = 4
LOSS = {"type": "vae", "recon_loss_type": "mse", "kl_weight": 1.0, "recon_weight": 1.0}
OPT = ({"type": "adam", "lr": 1e-3}, {"type": "constant"})
STEPS = 3


@pytest.fixture(scope="module")
def runs():
    """The same params, batches and noise through both packages: a forward,
    the step-1 gradients and three train steps, JAX's attention through its
    Pallas B4/B5 in interpret mode, the port's through FusedAttention; spies
    count the calls of each side's B4 function."""
    rs = np.random.RandomState(5)
    batches = [{
        "image_u8": rs.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8),
        "modality_idx": np.array([1, 4, 5, 7], np.int32),
        "channels": np.full((B,), 3, np.int32),
        "noise": rs.randn(B, 16, 16, 4).astype(np.float32),
    } for _ in range(STEPS)]
    x = rs.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    calls = {"jax": 0, "port": 0}
    with pytest.MonkeyPatch.context() as mp:
        from jax.experimental.pallas import tpu as pltpu

        mp.setattr(jattn, "_on_tpu", lambda: True)
        jax_fwd = jattn._attention_fwd_kernel

        def jax_spy(*a):
            calls["jax"] += 1
            return jax_fwd(*a)

        mp.setattr(jattn, "_attention_fwd_kernel", jax_spy)
        port_fwd = at.fused_attention_fwd

        def port_spy(*a):
            calls["port"] += 1
            return port_fwd(*a)

        mp.setattr(at, "fused_attention_fwd", port_spy)
        with pltpu.force_tpu_interpret_mode():
            jm = JaxBaseVAE(**SMALL, use_pallas=True)
            params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                      jnp.zeros((2, 32, 32, 3)))["params"]
            params = jax.tree_util.tree_map(np.asarray, params)
            noise = batches[0]["noise"]
            jax_out = jm.apply({"params": params}, jnp.asarray(x), noise=jnp.asarray(noise))
            jax_calls_forward = calls["jax"]
            mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
            jtx = joptim.build_optimizer(*OPT, gradient_clip_val=1.0)
            crit, forward = jstep.make_criterion(LOSS, jm), jstep.make_forward_fn(jm)

            def jloss(p, batch):
                xb = jstep.preprocess(batch, None, augment=False, max_channels=3)
                return crit({}, forward(p, xb, batch, {"sample": jax.random.PRNGKey(0)}), xb)["loss"]

            jax_grads = jax.jit(jax.grad(jloss))(params, {k: jnp.asarray(v) for k, v in batches[0].items()})
            jtrain = jstep.build_train_step(jm, LOSS, jtx, mesh, augment=False, max_channels=3, donate=False)
            state = replicate(mesh, jstate.create_train_state(params, jtx))
            jax_metrics = []
            for batch in batches:
                state, metrics = jtrain(state, shard_batch(mesh, batch), jax.random.PRNGKey(2))
                jax_metrics.append({k: float(v) for k, v in metrics.items()})

        model = build_model(dict(SMALL, _target_="medvae_tpu.models.BaseVAE"), "fp32", "cpu", train=True)
        model.load_state_dict(from_jax_params(params, model))
        with torch.no_grad():
            port_out = model(torch.from_numpy(x), noise=torch.from_numpy(noise))
        port_calls_forward = calls["port"]
        ttx = toptim.build_optimizer(*OPT, gradient_clip_val=1.0)
        tst = tstate.create_train_state(model, ttx)
        as_torch = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]
        _, torch_grads = tstep.build_loss_and_grads(model, LOSS)(tst, as_torch[0])
        train = tstep.build_train_step(model, LOSS, ttx, augment=False, max_channels=3)
        torch_metrics = []
        for batch in as_torch:
            tst, metrics = train(tst, batch)
            torch_metrics.append({k: float(v) for k, v in metrics.items()})
    return {
        "outputs": (jax_out, port_out), "calls_forward": (jax_calls_forward, port_calls_forward),
        "calls": dict(calls), "jax_metrics": jax_metrics, "torch_metrics": torch_metrics,
        "jax_grads": from_jax_grads(jax.tree_util.tree_map(np.asarray, jax_grads), model),
        "torch_grads": dict(zip(tst.params, torch_grads)),
    }


def test_every_attention_site_takes_b4_in_both_packages(runs):
    jax_forward, port_forward = runs["calls_forward"]
    # port: one B4 a site in the forward, the gradient pass and three steps
    assert port_forward == SITES
    assert runs["calls"]["port"] == SITES * (1 + 1 + STEPS)
    # JAX calls the kernel function while tracing, a whole number of times a site
    assert jax_forward > 0 and jax_forward % SITES == 0 and runs["calls"]["jax"] % SITES == 0


def test_base_vae_forward_on_b4_matches_jax(runs):
    want, got = runs["outputs"]
    for key in ("reconstruction", "mean", "logvar", "z"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4, err_msg=key)


@pytest.mark.parametrize("step", range(STEPS))
def test_base_vae_train_step_losses_match_jax(runs, step):
    want, got = runs["jax_metrics"][step], runs["torch_metrics"][step]
    for key in ("train/loss", "train/recon_loss", "train/kl_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-4, err_msg=key)
    np.testing.assert_allclose(got["train/grad_norm"], want["train/grad_norm"], rtol=1e-3)


def test_base_vae_step_one_gradients_on_b5_match_jax(runs):
    want, got = runs["jax_grads"], runs["torch_grads"]
    assert set(got) == set(want)
    attn = [n for n in want if re.search(r"attn(_1|\.\d+)\.(q|k|v|proj_out)\.weight$", n)]
    assert len(attn) == 4 * SITES  # B5's dq, dk, dv reach each of them
    for name in sorted(want):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)
