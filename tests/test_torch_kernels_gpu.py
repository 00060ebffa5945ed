"""The port's CUDA kernels (flash attention, payload pack / unpack)
against their plain versions on the card
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


# ---------------------------------------------------------------------------
# payload pack / unpack (K1, K2): byte-equal to the plain versions
# ---------------------------------------------------------------------------

from repro_torch.core import serialization  # noqa: E402
from repro_torch.kernels.payload_pack import (pack, pack_plain,  # noqa: E402
                                              unpack, unpack_plain)
from repro_torch.kernels.payload_pack import ops as pp_ops  # noqa: E402

PP_SIZES = [
    (128, 512, 1024, 128),                 # aligned, tests/test_kernels.py
    (1, 4096, 10, 127, 129),               # ragged edges
    (10, 10240, 1048576) * 3 + (10,),      # the default payload's sizes
    tuple(range(1, 600, 7)),               # 86 buffers: the large table
    (0, 300, 0, 5000),                     # zero-size buffers
]


def _rows(cuda, sizes, rows, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randint(0, 256, (rows, s), generator=g, device=cuda,
                          dtype=torch.uint8) for s in sizes]


@pytest.mark.parametrize("sizes", PP_SIZES)
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("pad", [True, False])
def test_pack_unpack_kernels_match_plain(cuda, sizes, rows, pad):
    bufs = _rows(cuda, sizes, rows, len(sizes) + rows)
    padded = [s + (-s) % 128 for s in sizes] if pad else list(sizes)
    before = (pp_ops.pack.launches, pp_ops.unpack.launches)
    packed, got_sizes = pack(bufs, pad=pad)
    outs = unpack(packed, got_sizes, pad=pad)
    torch.cuda.synchronize()
    assert (pp_ops.pack.launches, pp_ops.unpack.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(packed, pack_plain(bufs, padded))
    for a, b, c in zip(outs, unpack_plain(packed, sizes, padded), bufs):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_pack_kernel_writes_zero_pad_over_garbage(cuda):
    bufs = [torch.full((3, s), 7, dtype=torch.uint8, device=cuda)
            for s in (1, 200)]
    for _ in range(3):       # reuse allocator blocks that held 0xff bytes
        torch.full((3, 512), 255, dtype=torch.uint8, device=cuda)
        packed, _ = pack(bufs)
    assert (packed[:, 1:128] == 0).all() and (packed[:, 328:] == 0).all()


def test_pack_kernel_reads_strided_unaligned_views(cuda):
    base = _rows(cuda, (5000,), 8, 3)[0]
    bufs = [base[:, 3:103], base[:, 200:1224], base[:, 1:4001]]
    packed, _ = pack(bufs, pad=False)
    assert torch.equal(packed, torch.cat(bufs, -1))


def test_serialization_on_the_card_is_the_concatenation(cuda):
    bufs = _rows(cuda, (10, 1, 300, 4097, 77), 4, 9)
    packed, meta = serialization.pack(bufs)
    assert torch.equal(packed, torch.cat(bufs, -1))
    for a, b in zip(serialization.unpack(packed, meta), bufs):
        assert torch.equal(a, b)


def test_framing_kernel_backend_equals_numpy(cuda):
    from repro_torch.rpc import framing
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8)
            for n in (1, 127, 128, 129, 1000)]
    frame = framing.make_frame(7, "Serve/generate", bufs, serialized=True)
    before = pp_ops.pack.launches
    kw = framing.encode(frame, backend="kernel")
    assert pp_ops.pack.launches == before + 1
    nw = framing.encode(frame, backend="numpy")
    np.testing.assert_array_equal(kw[0], nw[0])
    for wire in (kw, nw):
        back = framing.decode(wire, backend="kernel")
        for a, b in zip(back.bufs, bufs):
            np.testing.assert_array_equal(a, b)


def test_pack_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="uint8"):
        pack([torch.zeros(2, 8, device=cuda)])
    with pytest.raises(ValueError, match="table holds"):
        pack([torch.zeros(1, 8, dtype=torch.uint8, device=cuda)] * 513)
    with pytest.raises(ValueError, match="contiguous"):
        pack([torch.zeros(8, 2, dtype=torch.uint8, device=cuda).t()])
    with pytest.raises(ValueError, match="one CUDA device"):
        pack([torch.zeros(1, 8, dtype=torch.uint8, device=cuda),
              torch.zeros(1, 8, dtype=torch.uint8)])
