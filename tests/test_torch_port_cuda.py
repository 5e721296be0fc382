"""The port's CUDA kernels on the card (`cuda` marker; skipped without a GPU).

The kernels have no CPU mode, so these run only on the machine with the
H100. This file imports nothing of JAX, so that it runs there without the
JAX test harness:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from medvae_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# (max abs, relative L2) by dtype, as in chip_smoke.py: the bf16 bar is a
# fraction of a typical output, so a kernel that drops a key tile fails it
TOLERANCE = {torch.bfloat16: (4e-3, 1e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.parametrize(
    "shape, dtype",
    [((2, 1000, 512), torch.bfloat16), ((2, 784, 1024), torch.bfloat16),
     ((1, 200, 64), torch.bfloat16), ((1, 300, 512), torch.float32),
     ((1, 100, 1024), torch.float32)],
)
def test_flash_kernel_matches_plain_version(gen, shape, dtype):
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    before = fa.launches
    got = fa.flash_attention(q, k, v).double()
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v).double()
    tol_abs, tol_rel = TOLERANCE[dtype]
    err = (got - want).abs().max().item()
    rel = (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)).item()
    assert err <= tol_abs and rel <= tol_rel, (err, rel)


def test_flash_wrapper_raises_on_the_card_instead_of_falling_back(gen):
    q = torch.randn((1, 64, 128), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.cpu(), q)
    t = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(t, t, t)
