"""The port's CUDA kernels against their plain versions on the card
(imports torch only, so it runs where JAX is not installed):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)

pytestmark = pytest.mark.gpu

# the cases of tests/test_kernels.py, plus odd lengths and the head dims
# the kernel is built for that those do not reach
FA_CASES = [
    # B, Sq, H, KV, dh, causal, window, softcap
    (2, 128, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, True, 64, None),
    (2, 128, 8, 2, 32, True, None, 50.0),
    (1, 192, 4, 1, 128, True, None, None),
    (2, 64, 4, 2, 64, False, None, None),
    (1, 320, 6, 2, 64, True, 128, 30.0),
    (1, 77, 4, 2, 16, True, None, None),
    (1, 100, 2, 1, 256, False, 16, None),
]
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    B, S, H, KV, dh, causal, window, cap = case
    rng = np.random.default_rng(S + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, getattr(torch, dtype))
               for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_plain(q, k, v, causal, window, cap)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 64, 2, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 66, device=cuda)[..., :64]   # 264-byte rows
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    # q, k, v as head slices of one fused (B, S, H + 2 KV, dh) projection
    B, S, H, KV, dh = 2, 96, 4, 2, 64
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(
        rng.standard_normal((B, S, H + 2 * KV, dh)).astype(np.float32)
    ).to(cuda, getattr(torch, dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, True)
    ref = attention_plain(*(t.contiguous() for t in (q, k, v)), True)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])
