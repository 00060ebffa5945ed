"""The port's CUDA kernels (flash attention, payload pack / unpack, the
RWKV-6 WKV scan) against their plain versions on the card
(imports torch only, so it runs where JAX is not installed):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a card every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 kernel_path)

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
    path = kernel_path(getattr(torch, dtype), dh)
    on_path = flash_attention.launches_by_path[path]
    out = flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_path[path] == on_path + 1
    if dtype == "bfloat16" and dh in (64, 128):
        assert path == "wgmma"
    ref = attention_plain(q, k, v, causal, window, cap)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


# the wgmma path (bf16, dh 64 / 128) at its edges: the Qwen3-8B prefill
# shape, a length that is not a multiple of the 128-row tile, G = 1, 4 and
# 8 q heads a kv head, non-causal, window with softcap
WG_CASES = [
    (4, 512, 32, 8, 128, True, None, None),
    (1, 200, 8, 2, 128, True, None, None),
    (2, 200, 4, 4, 64, True, None, None),
    (1, 256, 8, 1, 128, True, None, None),
    (1, 200, 8, 8, 128, False, None, None),
    (1, 320, 4, 1, 128, True, 100, 20.0),
    (2, 130, 8, 2, 64, True, 48, 30.0),
]


@pytest.mark.parametrize("case", WG_CASES)
@pytest.mark.parametrize("fused", [False, True])
def test_wgmma_path_matches_plain(cuda, case, fused):
    B, S, H, KV, dh, causal, window, cap = case
    rng = np.random.default_rng(S + H)
    if fused:   # head slices of one (B, S, H + 2 KV, dh) projection
        qkv = torch.from_numpy(rng.standard_normal(
            (B, S, H + 2 * KV, dh)).astype(np.float32)).to(cuda,
                                                            torch.bfloat16)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda, torch.bfloat16)
            for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
    before = flash_attention.launches_by_path["wgmma"]
    out = flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["wgmma"] == before + 1
    ref = attention_plain(q, k, v, causal, window, cap)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


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


# ---------------------------------------------------------------------------
# RWKV-6 WKV scan (K4): against rwkv6_scan_plain and the sequential oracle
# ---------------------------------------------------------------------------

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    rwkv6_ref, rwkv6_scan_plain)

# tests/test_kernels.py's cases (BH, S, hs, chunk, with_u), the other head
# sizes and chunks the kernel is built for, and the serving shape
WKV_CASES = [
    (4, 128, 64, 32, True), (2, 64, 32, 16, False),
    (3, 96, 64, 32, True), (1, 250, 64, 64, True),
    (5, 48, 16, 16, True), (2, 100, 32, 8, False), (3, 7, 64, 64, True),
    (128, 512, 64, 16, True),
]


def _wkv_inputs(cuda, BH, S, hs, with_u, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    return (randn(BH, S, hs), randn(BH, S, hs) * 0.5, randn(BH, S, hs),
            -torch.exp(randn(BH, S, hs) - 1.0), randn(BH, hs, hs) * 0.1,
            randn(BH, hs) * 0.5 if with_u else None)


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_kernel_matches_plain_and_ref(cuda, case):
    BH, S, hs, chunk, with_u = case
    r, k, v, lw, s0, u = _wkv_inputs(cuda, BH, S, hs, with_u, S + hs)
    before = rwkv6_scan.launches
    y, sT = rwkv6_scan(r, k, v, lw, s0, u, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    c = min(chunk, max(8, S))
    pad = (-S) % c
    padded = [torch.nn.functional.pad(t, (0, 0, 0, pad))
              for t in (r, k, v, lw)]
    yp, sTp = rwkv6_scan_plain(*padded, s0, chunk=c)
    if u is not None:
        yp = yp[:, :S] + (r * k * u[:, None, :]).sum(-1, keepdim=True) * v
    torch.testing.assert_close(y, yp[:, :S], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sT, sTp, atol=1e-4, rtol=1e-4)
    if BH * S <= 1024:
        yr, sTr = rwkv6_ref(r, k, v, lw, s0, u)
        torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(sT, sTr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_wkv_kernel_column_split_matches_plain(cuda, chunk):
    """hs 64 at each chunk: one block owns a row's 64 value columns where
    the tiles fit (chunk 16, 32), two blocks of 32 where they do not
    (chunk 64)."""
    r, k, v, lw, s0, _ = _wkv_inputs(cuda, 6, 128, 64, False, chunk)
    y, sT = wkv_ops._launch(r, k, v, lw, s0, chunk)
    yp, sTp = rwkv6_scan_plain(r, k, v, lw, s0, chunk=chunk)
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sT, sTp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S", [512, 50])
def test_wkv_kernel_model_layout_matches_folded_plain(cuda, S):
    """The (B, S, H, hs) entry, r and v as strided head slices of one
    fused tensor, against the folded plain scan (padding and u too)."""
    B, H, hs = 2, 4, 64
    g = torch.Generator(device=cuda).manual_seed(S)
    fused = torch.randn(B, S, 4 * H, hs, generator=g, device=cuda)
    r, k, v, lw = (fused[:, :, j * H:(j + 1) * H] for j in range(4))
    k, lw = k * 0.5, -torch.exp(lw - 1.0)
    s0 = torch.randn(B, H, hs, hs, generator=g, device=cuda) * 0.1
    u = torch.randn(H, hs, generator=g, device=cuda) * 0.5
    before = rwkv6_scan.launches
    y, sT = rwkv6_scan(r, k, v, lw, s0, u, chunk=16)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert y.shape == (B, S, H, hs) and sT.shape == (B, H, hs, hs)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, hs)
    yr, sTr = rwkv6_scan(*(fold(t) for t in (r, k, v, lw)),
                         s0.reshape(B * H, hs, hs), u.repeat(B, 1), chunk=16)
    pad = (-S) % 16
    padded = (torch.nn.functional.pad(fold(t), (0, 0, 0, pad))
              for t in (r, k, v, lw))
    yp, sTp = rwkv6_scan_plain(*padded, s0.reshape(B * H, hs, hs),
                               chunk=16)
    yp = yp[:, :S] + (fold(r) * fold(k) * u.repeat(B, 1)[:, None]).sum(
        -1, keepdim=True) * fold(v)
    torch.testing.assert_close(fold(y), yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sT.reshape(B * H, hs, hs), sTp, atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(fold(y), yr, atol=1e-4, rtol=1e-4)


def test_wkv_kernel_strong_decay_stays_finite(cuda):
    BH, S, hs = 2, 64, 32
    ones = torch.ones(BH, S, hs, device=cuda)
    y, sT = rwkv6_scan(ones, ones, ones, torch.full_like(ones, -30.0),
                       torch.zeros(BH, hs, hs, device=cuda), None, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    yp, sTp = rwkv6_scan_plain(ones, ones, ones, torch.full_like(ones, -30.0),
                               torch.zeros(BH, hs, hs, device=cuda),
                               chunk=16)
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sT, sTp, atol=1e-4, rtol=1e-4)
    assert (y - yp).abs().max().item() == 0.0
    assert (sT - sTp).abs().max().item() == 0.0


def test_wkv_kernel_refuses_what_it_does_not_take(cuda):
    t = torch.zeros(2, 32, 64, device=cuda)
    s0 = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        wkv_ops._launch(t.bfloat16(), t, t, t, s0, 16)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops._launch(t.transpose(1, 2).contiguous().transpose(1, 2),
                        t, t, t, s0, 16)
    with pytest.raises(ValueError, match="divide"):
        wkv_ops._launch(t, t, t, t, s0, 12)
    with pytest.raises(ValueError, match="chunk"):
        wkv_ops._launch(t, t, t, t, s0, 128)
    with pytest.raises(ValueError, match="head size"):
        x = torch.zeros(2, 32, 48, device=cuda)
        wkv_ops._launch(x, x, x, x, torch.zeros(2, 48, 48, device=cuda), 16)
    with pytest.raises(ValueError, match="one CUDA device"):
        wkv_ops._launch(t, t, t, t, s0.cpu(), 16)
