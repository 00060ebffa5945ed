"""The port's CUDA kernels (flash attention, payload pack / unpack, the
RWKV-6 WKV scan, the MoE decode's routed-expert FFN, the Mamba-2 chunked
SSD scan) against their plain versions on the card, the flash
kernel under autograd in a train step, the MoE and Mamba models and the
sampler's key chain and noise on the card against the CPU (imports torch only, so it runs where JAX is
not installed):

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
# the kernel is built for that those do not reach; dh 16 and 32 run the
# dh-64 instance on zero-padded inputs
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
    # Gemma-2's kind: dh 256, a window, softcap 50, GQA
    (1, 300, 4, 2, 256, True, 100, 50.0),
    # hubert-xlarge's dh 80 and kimi-k2's dh 112, read unpadded, causal
    # and not, GQA; then head dims without an instance, zero-padded to
    # the next one: 48 (as 64) and 96 (as 112)
    (1, 256, 4, 2, 80, False, None, None),
    (2, 200, 16, 16, 80, True, None, None),
    (1, 256, 8, 1, 112, True, None, None),
    (1, 130, 8, 2, 112, False, 48, 30.0),
    (1, 100, 4, 2, 48, True, None, None),
    (1, 90, 4, 2, 96, False, None, None),
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
    path = kernel_path(getattr(torch, dtype))
    on_path = flash_attention.launches_by_path[path]
    out = flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_path[path] == on_path + 1
    assert path == ("wgmma" if dtype == "bfloat16" else "simt")
    ref = attention_plain(q, k, v, causal, window, cap)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


# the wgmma path (bf16) at its edges: the Qwen3-8B prefill shape, a
# length that is not a multiple of the 128-row tile, G = 1, 4 and 8 q
# heads a kv head, non-causal, window with softcap; then the head dims
# whose last column block is partial (80, 112) and dh 256's 64-key tiles
# at a ragged length, G = 1 and 8, causal and not; then softcap 50 where
# it binds, q scaled by the last number so that the scaled logits reach
# +-30 and past 100 (at randn inputs they stay near +-1, where the softcap
# changes nothing the tolerance sees), at dh 256, 128, 80 and 112
WG_CASES = [
    (4, 512, 32, 8, 128, True, None, None),
    (1, 200, 8, 2, 128, True, None, None),
    (2, 200, 4, 4, 64, True, None, None),
    (1, 256, 8, 1, 128, True, None, None),
    (1, 200, 8, 8, 128, False, None, None),
    (1, 320, 4, 1, 128, True, 100, 20.0),
    (2, 130, 8, 2, 64, True, 48, 30.0),
    (1, 200, 8, 8, 80, True, None, None),
    (2, 130, 4, 4, 80, False, None, None),
    (1, 200, 8, 1, 112, True, None, None),
    (2, 130, 8, 8, 112, False, 48, 30.0),
    (1, 200, 8, 1, 256, True, None, 50.0),
    (2, 130, 8, 8, 256, False, None, None),
    (1, 200, 8, 1, 256, True, 100, 50.0, 30.0),
    (2, 130, 8, 2, 128, True, None, 50.0, 30.0),
    (1, 200, 8, 8, 80, False, None, 50.0, 30.0),
    (2, 130, 8, 1, 112, True, 48, 50.0, 30.0),
]


@pytest.mark.parametrize("case", WG_CASES)
@pytest.mark.parametrize("fused", [False, True])
def test_wgmma_path_matches_plain(cuda, case, fused, monkeypatch):
    """Fused: q, k and v are head slices of one projection, read in place
    (dh 80 and 112 too: no pad copy), with the result of the same call
    on contiguous copies. Where q is scaled, the same attention without
    the softcap must miss the tolerance."""
    from repro_torch.kernels.flash_attention import ops
    B, S, H, KV, dh, causal, window, cap = case[:8]
    q_scale = case[8] if len(case) > 8 else 1.0
    rng = np.random.default_rng(S + H)
    if fused:   # head slices of one (B, S, H + 2 KV, dh) projection
        qkv = rng.standard_normal((B, S, H + 2 * KV, dh)).astype(np.float32)
        qkv[:, :, :H] *= q_scale
        qkv = torch.from_numpy(qkv).to(cuda, torch.bfloat16)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32) * scale).to(cuda, torch.bfloat16)
            for s, scale in (((B, S, H, dh), q_scale), ((B, S, KV, dh), 1.0),
                             ((B, S, KV, dh), 1.0)))

    def no_pad(*args):
        raise AssertionError(f"dh {dh} was padded on the host")
    monkeypatch.setattr(ops, "padded", no_pad)
    before = flash_attention.launches_by_path["wgmma"]
    out = flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["wgmma"] == before + 1
    ref = attention_plain(q, k, v, causal, window, cap)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    if q_scale != 1.0:
        assert not torch.allclose(
            attention_plain(q, k, v, causal, window, None).float(),
            ref.float(), atol=2e-2, rtol=2e-2)
    if fused:
        assert torch.equal(out, flash_attention(
            *(t.contiguous() for t in (q, k, v)), causal, window, cap))


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 264, device=cuda)
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


def test_wkv_kernel_refuses_inputs_that_need_a_gradient(cuda):
    """K4 has no backward (the reference's kernel defines no VJP): an
    input that requires a gradient is refused, where its output would
    otherwise carry no grad_fn and leave the time mix untrained."""
    r, k, v, lw, s0, u = _wkv_inputs(cuda, 2, 32, 64, True, 5)
    before = rwkv6_scan.launches
    with pytest.raises(ValueError, match="no backward"):
        rwkv6_scan(r.requires_grad_(), k, v, lw, s0, u, chunk=16)
    with pytest.raises(ValueError, match="no backward"):
        rwkv6_scan(r.detach(), k, v, lw, s0, u.requires_grad_(), chunk=16)
    assert rwkv6_scan.launches == before
    with torch.no_grad():           # serving: no gradient wanted
        rwkv6_scan(r, k, v, lw, s0, u, chunk=16)
    assert rwkv6_scan.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradient_matches_plain(cuda, dtype):
    """Under autograd the kernel runs the forward and the backward
    recomputes through attention_plain (the reference's custom VJP
    recomputes through attention_ref): the gradients equal plain's, and
    the backward launches no kernel."""
    B, S, H, KV, dh = 2, 200, 8, 2, 128
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .to(cuda, getattr(torch, dtype))
                  for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh),
                            (B, S, H, dh)))
    grads = []
    for fn in (flash_attention, attention_plain):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, True)
        before = flash_attention.launches
        grads.append(torch.autograd.grad(out, leaves, g))
        assert flash_attention.launches == before
    tol = TOLS[dtype]
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_launches_flash_per_layer(cuda, remat):
    """A train step of the reduced Qwen3-8B (fp32) with the flash kernel
    launches it once a layer in the forward and, under remat, once more
    a layer when the backward recomputes the layer; its loss equals the
    plain path's."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import device_batch, host_batch
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params
    from repro_torch.optim import optimizer as O

    base = get_reduced_config("qwen3-8b")
    shape = ShapeSpec("t", seq_len=64, global_batch=2, kind="train")
    batch = device_batch(host_batch(base, shape, 0), cuda)
    losses = []
    for flash in (True, False):
        acfg = base.replace(train=dataclasses.replace(
            base.train, remat=remat, use_flash_kernel=flash))
        params = init_params(acfg, device=cuda,
                             generator=torch.Generator(device=cuda).manual_seed(0))
        before = flash_attention.launches
        _, _, metrics = steps.make_train_step(acfg)(
            params, O.init_opt_state(acfg.train, params,
                                     period=acfg.model.pattern_period),
            batch)
        losses.append(float(metrics["loss"]))
        layers = acfg.model.num_layers
        want = (2 if remat else 1) * layers if flash else 0
        assert flash_attention.launches - before == want
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])


def _moe_acfg(arch, dtype, **moe):
    """A reduced config with its MoE widened by ``moe`` and compute in
    ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    acfg = get_reduced_config(arch)
    model = acfg.model
    if moe:
        model = dataclasses.replace(model, moe=dataclasses.replace(
            model.moe, **moe))
    return acfg.replace(model=model, train=dataclasses.replace(
        acfg.train, compute_dtype=dtype, use_flash_kernel=True))


def test_moe_prefill_is_bit_identical_across_runs(cuda):
    """A bf16 prefill of an MoE model with Kimi-K2's top-8 of many
    experts at the capacity that drops tokens: the combine sums each
    token's 8 expert outputs in a fixed order, so two runs give the same
    bits (a scatter-add in atomic order would not)."""
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params
    acfg = _moe_acfg("kimi-k2-1t-a32b", "bfloat16", num_experts=32,
                     top_k=8, capacity_factor=1.25)
    gen = torch.Generator(device=cuda)
    params = init_params(acfg, device=cuda, dtype=torch.bfloat16,
                         generator=gen.manual_seed(0))
    tokens = torch.randint(0, acfg.model.vocab_size, (4, 96), device=cuda,
                           generator=gen.manual_seed(1))
    prefill = steps.make_prefill_step(acfg, max_seq=100)
    runs = [prefill(params, {"tokens": tokens}) for _ in range(2)]
    (s0, l0), (s1, l1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(s0, s1):
        assert torch.equal(a["mixer"].k, b["mixer"].k)
        assert torch.equal(a["mixer"].v, b["mixer"].v)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b",
                                  "kimi-k2-instruct"])
def test_reduced_fp32_forward_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced model in fp32, the same parameters on the card (K3 on
    its SIMT path, the MoE dispatch, Mamba's chunked SSD) and on the CPU:
    hidden states, the router's aux loss, and a decode step from the
    prefill's states, within 1e-4."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_map
    acfg = _moe_acfg(arch, "float32")
    params = M.init_params(acfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, acfg.model.vocab_size, (2, 71), dtype=np.int32))
    tokens, nxt = tokens[:, :70], tokens[:, 70:]
    out = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        with torch.no_grad():
            hidden, _, aux = M.forward(acfg, p, tokens=tokens.to(dev))
        states, logits = steps.make_prefill_step(acfg, max_seq=72)(
            p, {"tokens": tokens.to(dev)})
        _, step_logits = steps.make_decode_step(acfg, 2)(p, states,
                                                         nxt.to(dev))
        out.append([t.cpu() for t in (hidden, aux, logits, step_logits)])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dh", [128, 80])
def test_flash_per_shard_entry_on_a_1x1_mesh_is_the_direct_call(cuda, dh):
    """K3 through the per-shard entry (``flash_attention_sharded``, the
    mesh path's) on a 1 x 1 NCCL mesh: one launch on wgmma, the same
    bits as the direct call (bf16; dh 80 read unpadded)."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention.ops import \
        flash_attention_sharded
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel.sharding import ParallelCtx

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    mesh_lib.init_single("cuda")
    try:
        ctx = ParallelCtx(mesh=mesh_lib.make_mesh((1, 1), ("data", "model"),
                                                  device="cuda"))
        rng = np.random.default_rng(dh)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(cuda, torch.bfloat16)
            for s in ((2, 256, 8, dh), (2, 256, 2, dh), (2, 256, 2, dh)))
        direct = flash_attention(q, k, v, True)
        on = [ctx.constrain(t, "batch", None, "heads", None)
              for t in (q, k, v)]
        before = dict(flash_attention.launches_by_path)
        out = flash_attention_sharded(ctx, *on, True)
        torch.cuda.synchronize()
        assert flash_attention.launches_by_path["wgmma"] == \
            before["wgmma"] + 1
        assert tuple(out.placements) == tuple(on[0].placements)
        assert torch.equal(out.to_local(), direct)
    finally:
        dist.destroy_process_group()


def test_wkv_per_shard_entry_on_a_1x1_mesh_is_the_direct_call(cuda):
    """K4 through the per-shard entry (``rwkv6_scan_shard``, the mesh
    path's) inside a per-shard body on a 1 x 1 NCCL mesh, its heads
    split over ``model``: one launch, the same bits as the direct
    ``rwkv6_scan`` call."""
    import torch.distributed as dist

    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    mesh_lib.init_single("cuda")
    try:
        ctx = sh.ParallelCtx(mesh=mesh_lib.make_mesh(
            (1, 1), ("data", "model"), device="cuda"))
        rng = np.random.default_rng(5)
        B, S, H, hs = 2, 96, 8, 64
        r, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, H, hs)).astype(np.float32)).to(cuda) for _ in range(3))
        lw = -torch.exp(torch.from_numpy(rng.standard_normal(
            (B, S, H, hs)).astype(np.float32)).to(cuda) - 1.0)
        s0 = torch.zeros((B, H, hs, hs), device=cuda)
        u = torch.from_numpy(rng.standard_normal((H, hs)).astype(
            np.float32)).to(cuda)
        y, sT = rwkv6_scan(r, k, v, lw, s0, u, chunk=16)
        on = [ctx.constrain(t, "batch", None, "heads", None)
              for t in (r, k, v, lw)]
        s_on = ctx.constrain(s0, "batch", "heads", None, None)
        before = rwkv6_scan.launches
        ys, sTs = sh.shard_map(
            ctx, lambda *a: rwkv6_scan_shard(*a, u, chunk=16),
            (*on, s_on), (on[0].placements, s_on.placements))
        torch.cuda.synchronize()
        assert rwkv6_scan.launches == before + 1
        assert torch.equal(ys.to_local(), y)
        assert torch.equal(sTs.to_local(), sT)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_recurrent_prefill_on_a_1x1_mesh_equals_no_mesh(cuda, arch):
    """The reduced RWKV-6 and Jamba (fp32, K4 / K3 on) prefill then two
    greedy decode steps over a 1 x 1 NCCL mesh (fsdp on): the logits of
    every step equal the no-mesh run's, and so do the tokens."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import NO_MESH, full, make_ctx

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    acfg = get_reduced_config(arch)
    acfg = acfg.replace(
        train=dataclasses.replace(acfg.train, use_flash_kernel=True,
                                  use_rwkv_kernel=True),
        parallel=dataclasses.replace(acfg.parallel, fsdp=True))
    params = M.init_params(acfg, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, acfg.model.vocab_size, (2, 70), dtype=np.int32)).to(cuda)
    mesh_lib.init_single("cuda")
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cuda")
        runs = []
        for ctx in (NO_MESH, make_ctx(acfg, mesh)):
            p = M.distribute_params(ctx, acfg, params)
            states, logits = steps.make_prefill_step(acfg, 73, ctx)(
                p, {"tokens": tokens})
            decode = steps.make_decode_step(acfg, 2, ctx)
            seen = [full(logits)[:, -1]]
            for _ in range(2):
                nxt = torch.argmax(seen[-1], dim=-1).to(torch.int32)
                states, logits = decode(p, states, nxt[:, None])
                seen.append(full(logits)[:, -1])
            runs.append(seen)
        for a, b in zip(*runs):
            torch.testing.assert_close(b, a, atol=1e-5, rtol=1e-5)
            assert torch.equal(torch.argmax(a, -1), torch.argmax(b, -1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_roofline_counts_on_the_card_equal_the_cpu_counts(cuda, kind):
    """``roofline.segment_costs`` of a reduced Qwen3 (the plain paths)
    on real tensors on the card and on fake tensors on the CPU: the same
    FLOPs, and bytes within 1 %."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import roofline as R
    from repro_torch.parallel.sharding import NO_MESH
    acfg = get_reduced_config("qwen3-8b", n_layers=2)
    acfg = acfg.replace(train=dataclasses.replace(
        acfg.train, compute_dtype="bfloat16"))
    shape = ShapeSpec(kind, seq_len=128, global_batch=2, kind=kind)
    on_card = R.segment_costs(NO_MESH, acfg, shape, device="cuda")
    with FakeTensorMode(allow_non_fake_inputs=True):
        on_cpu = R.segment_costs(NO_MESH, acfg, shape, device="cpu")
    assert on_card.keys() == on_cpu.keys()
    for k in on_cpu:
        assert on_card[k].flops == on_cpu[k].flops, k
        assert on_card[k].bytes_accessed == pytest.approx(
            on_cpu[k].bytes_accessed, rel=1e-2), k


# ---------------------------------------------------------------------------
# temperature sampling: JAX's key chain and Gumbel noise (core/prng.py),
# on the card against the CPU at the tolerances of chip_smoke.py [sample]
# ---------------------------------------------------------------------------

from repro_torch.core import prng  # noqa: E402

SAMPLE_SHAPE = (4, 151936)


def test_sampler_chain_and_noise_on_the_card_equal_the_cpus(cuda):
    """Each split of the chain from seed 0, hashed on the card, equals
    the host's; random bits are equal, bf16 Gumbel noise within one ulp
    and fp32 within 2e-6 of the CPU's; a categorical draw of fp32 logits
    on the card gives the CPU's tokens."""
    key = prng.prng_key(0)
    for _ in range(8):
        counters = torch.arange(2, dtype=torch.int64, device=cuda)
        a, b = prng.threefry2x32(key[0], key[1], counters >> 32, counters)
        key, sub = prng.split(key)
        assert tuple(zip(a.tolist(), b.tolist())) == (key, sub)
    for width in (8, 16, 32):
        assert torch.equal(prng.random_bits(sub, width, SAMPLE_SHAPE,
                                            cuda).cpu(),
                           prng.random_bits(sub, width, SAMPLE_SHAPE))
    ulps = prng.bf16_ulps(prng.gumbel(sub, SAMPLE_SHAPE, torch.bfloat16,
                                     cuda),
                        prng.gumbel(sub, SAMPLE_SHAPE, torch.bfloat16))
    assert ulps.max().item() <= 1
    f32 = prng.gumbel(sub, SAMPLE_SHAPE, torch.float32, cuda).cpu()
    torch.testing.assert_close(f32, prng.gumbel(sub, SAMPLE_SHAPE,
                                                torch.float32),
                               atol=2e-6, rtol=0)
    logits = torch.randn(SAMPLE_SHAPE, generator=torch.Generator()
                         .manual_seed(0)) * 3
    assert torch.equal(prng.categorical(sub, logits.to(cuda)).cpu(),
                       prng.categorical(sub, logits))


# ---------------------------------------------------------------------------
# K5: the MoE decode's routed-expert GLU FFN (csrc/moe_decode.cu)
# ---------------------------------------------------------------------------

from repro_torch.kernels.moe_decode import (moe_decode_ffn,  # noqa: E402
                                            moe_decode_plain)

#: (k, d, f, E): Mixtral-8x7B's top-2 of 8 experts, Granite-4.0-H-Small's
#: top-10 of 72, at their published widths
K5_SHAPES = {"mixtral": (2, 4096, 14336, 8), "granite": (10, 4096, 768, 72)}
K5_TOLS = {"float32": 1e-4, "bfloat16": 2e-2}


def _k5_weights(cuda, dtype, d, f, E, seed=0):
    """w_gate, w_up (E, d, f) and w_down (E, f, d) at the scale that keeps
    each product's outputs near 1."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [(torch.randn(shape, device=cuda, generator=gen) * n ** -0.5)
            .to(dtype) for shape, n in (((E, d, f), d), ((E, d, f), d),
                                        ((E, f, d), f))]


def _k5_rows(cuda, dtype, T, k, d, E, seed=1):
    """(rows (T*k, d), ids (T*k,)): at one token its row shared by its k
    slots (a row stride of 0, as the model passes it); ids drawn with
    repeats, the first 0 and the last E - 1, a repeat at the third."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(T, d, device=cuda, generator=gen).to(dtype)
    rows = x[:, None, :].expand(T, k, d).reshape(T * k, d)
    ids = torch.randint(0, E, (T * k,), device=cuda, generator=gen)
    ids[0], ids[-1] = 0, E - 1
    if T * k > 2:
        ids[2] = ids[1]
    return rows, ids


@pytest.mark.parametrize("shape", sorted(K5_SHAPES))
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_matches_plain(cuda, shape, T, dtype):
    k, d, f, E = K5_SHAPES[shape]
    dt = getattr(torch, dtype)
    ws = _k5_weights(cuda, dt, d, f, E)
    rows, ids = _k5_rows(cuda, dt, T, k, d, E)
    assert (rows.stride(0) == 0) == (T == 1)
    before = moe_decode_ffn.launches
    out = moe_decode_ffn(rows, ids, *ws, "silu")
    torch.cuda.synchronize()
    assert moe_decode_ffn.launches == before + 1
    assert out.shape == (T * k, d) and out.dtype == dt
    ref = moe_decode_plain(rows, ids, *ws, "silu")
    torch.testing.assert_close(out.float(), ref.float(), atol=K5_TOLS[dtype],
                               rtol=K5_TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_tanh_gelu_matches_plain(cuda, dtype):
    dt = getattr(torch, dtype)
    ws = _k5_weights(cuda, dt, 256, 384, 6)
    rows, ids = _k5_rows(cuda, dt, 3, 2, 256, 6)
    torch.testing.assert_close(
        moe_decode_ffn(rows, ids, *ws, "gelu").float(),
        moe_decode_plain(rows, ids, *ws, "gelu").float(),
        atol=K5_TOLS[dtype], rtol=K5_TOLS[dtype])


@pytest.mark.parametrize("shape", sorted(K5_SHAPES))
def test_k5_gives_the_same_bits_every_run(cuda, shape):
    """The splits' partial sums are added in a fixed order, with no
    atomics."""
    k, d, f, E = K5_SHAPES[shape]
    ws = _k5_weights(cuda, torch.bfloat16, d, f, E)
    rows, ids = _k5_rows(cuda, torch.bfloat16, 3, k, d, E)
    runs = [moe_decode_ffn(rows, ids, *ws) for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_k5_replays_in_a_cuda_graph_with_new_ids(cuda):
    """Captured once, replayed after the id tensor is rewritten in place:
    the kernel reads its experts on the device, so the replay computes
    the new experts' outputs."""
    k, d, f, E = K5_SHAPES["granite"]
    ws = _k5_weights(cuda, torch.bfloat16, d, f, E)
    rows, ids = _k5_rows(cuda, torch.bfloat16, 1, k, d, E)
    moe_decode_ffn(rows, ids, *ws)                  # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe_decode_ffn(rows, ids, *ws)
    for seed in (2, 3):
        new = torch.randperm(E, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(seed))[:k]
        ids.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        ref = moe_decode_plain(rows, new, *ws, "silu")
        torch.testing.assert_close(out.float(), ref.float(),
                                   atol=K5_TOLS["bfloat16"],
                                   rtol=K5_TOLS["bfloat16"])


@pytest.mark.parametrize("offset", [0, 16])
def test_k5_skips_experts_it_does_not_hold(cuda, offset):
    """Kimi-K2's top-8 at its widths over weights of 8 experts held from
    ``offset`` of a router of 384: rows routed elsewhere are exactly
    zero, the others equal the plain version's, directly and replayed
    in a CUDA graph with new ids."""
    k, d, f, E = 8, 7168, 2048, 8
    ws = _k5_weights(cuda, torch.bfloat16, d, f, E)
    rows, _ = _k5_rows(cuda, torch.bfloat16, 1, k, d, E)
    ids = torch.tensor([offset, 300, offset + 7, 0, offset + 3, 383,
                        offset + 3, 17], device=cuda)
    held = (ids >= offset) & (ids < offset + E)
    out = moe_decode_ffn(rows, ids, *ws, "silu", offset)
    ref = moe_decode_plain(rows, ids, *ws, "silu", offset)
    assert torch.equal(out[~held], torch.zeros_like(out[~held]))
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=K5_TOLS["bfloat16"],
                               rtol=K5_TOLS["bfloat16"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe_decode_ffn(rows, ids, *ws, "silu", offset)
    new = torch.tensor([383, offset + 1, 5, offset + 6, 200, 201, offset,
                        offset + 2], device=cuda)
    ids.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    held = (new >= offset) & (new < offset + E)
    assert torch.equal(out[~held], torch.zeros_like(out[~held]))
    torch.testing.assert_close(
        out.float(), moe_decode_plain(rows, new, *ws, "silu", offset)
        .float(), atol=K5_TOLS["bfloat16"], rtol=K5_TOLS["bfloat16"])


def test_k5_refuses_what_it_does_not_take(cuda):
    ws = _k5_weights(cuda, torch.bfloat16, 64, 96, 4)
    rows, ids = _k5_rows(cuda, torch.bfloat16, 1, 2, 64, 4)
    before = moe_decode_ffn.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        moe_decode_ffn(rows.cpu(), ids, *ws)
    with pytest.raises(ValueError, match="one CUDA device"):
        moe_decode_ffn(rows, ids.cpu(), *ws)
    with pytest.raises(ValueError, match="one CUDA device"):
        moe_decode_ffn(rows, ids, ws[0].cpu(), *ws[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_decode_ffn(rows.half(), ids, *(w.half() for w in ws))
    with pytest.raises(TypeError, match="one dtype"):
        moe_decode_ffn(rows, ids, ws[0].float(), *ws[1:])
    with pytest.raises(TypeError, match="int64"):
        moe_decode_ffn(rows, ids.int(), *ws)
    with pytest.raises(ValueError, match="contiguous"):
        moe_decode_ffn(rows, ids, ws[0].transpose(1, 2).contiguous()
                       .transpose(1, 2), *ws[1:])
    with pytest.raises(ValueError, match="shapes"):
        moe_decode_ffn(rows, ids, ws[0], ws[1], ws[1])
    with pytest.raises(ValueError, match="no backward"):
        moe_decode_ffn(rows, ids, ws[0].requires_grad_(), *ws[1:])
    assert moe_decode_ffn.launches == before


@pytest.mark.parametrize("E,k,T", [(8, 2, 1), (8, 2, 3), (72, 10, 1)])
def test_routed_branch_matches_the_dispatch_on_the_card(cuda, E, k, T):
    """``_moe_local`` in bf16 on the card: dropless at T*k < E it launches
    K5 and dispatches nothing; at T <= 4 a capacity that drops is T, so
    ``dropless=False`` runs the dispatch over every expert with every
    assignment kept. The two agree within bf16 rounding."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.models import moe
    cfg = get_reduced_config("mixtral-8x7b").model
    cfg = dataclasses.replace(cfg, d_model=512, moe=dataclasses.replace(
        cfg.moe, num_experts=E, top_k=k, d_ff_expert=768))
    p = moe.init_moe(cfg, cfg.moe, torch.bfloat16, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    x = torch.randn(T, 512, device=cuda, generator=torch.Generator(
        cuda).manual_seed(1)).bfloat16()
    assert moe._capacity(cfg.moe, T, False) == T
    before = moe_decode_ffn.launches
    with torch.no_grad():
        routed, _ = moe._moe_local(cfg, cfg.moe, p, x, dropless=True)
        assert moe_decode_ffn.launches == before + 1
        dense, _ = moe._moe_local(cfg, cfg.moe, p, x, dropless=False)
        assert moe_decode_ffn.launches == before + 1
    scale = dense.float().abs().max().item()
    torch.testing.assert_close(routed.float(), dense.float(),
                               atol=2e-2 * scale, rtol=2e-2)


# ---------------------------------------------------------------------------
# K6: the Mamba-2 chunked SSD scan (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

from repro_torch.kernels.ssd_scan import (mamba_ssd_chunked,  # noqa: E402
                                          ssd_scan, ssd_scan_plain)
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402

#: Granite-4.0-H-Small's mixer: 128 heads of 64, d_state 128, one group
K6_SHAPE = (128, 64, 128)
#: Both sides are fp32 throughout. They differ in the order of the sums
#: (the kernel's register tiles against the einsums'), in the cumulative
#: sum's rounding after its scaling by log2(e), and in ex2.approx (2 ulp)
#: for exp: about 1e-6 of the outputs' scale. 1e-4 of it leaves room for
#: that over 63 chunks of state; a lost or doubled term (a chunk's state
#: dropped, one decay too many) moves y and the state by their whole
#: scale.
K6_TOL = 1e-4


def _k6_inputs(cuda, S, H, P, N, seed=0, B=1):
    """As a Mamba-2 layer hands them: B and C of order 1, the dt-scaled
    inputs of order 0.1, log decays in [-0.5, 0], a non-zero state."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, device=cuda, generator=gen)
    return (rn(B, S, H, P) * 0.1, rn(B, S, N), rn(B, S, N),
            -0.5 * torch.rand((B, S, H), device=cuda, generator=gen),
            rn(B, H, P, N) * 0.3)


def _k6_close(out, ref):
    scale = ref.abs().max().item()
    torch.testing.assert_close(out, ref, atol=K6_TOL * scale, rtol=K6_TOL)


@pytest.mark.parametrize("S", [1, 63, 64, 1905, 4000])
def test_k6_matches_plain(cuda, S):
    H, P, N = K6_SHAPE
    ins = _k6_inputs(cuda, S, H, P, N, seed=S)
    before = ssd_scan.launches
    y, h = ssd_scan(*ins)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.shape == ins[0].shape and h.shape == ins[4].shape
    yp, hp = ssd_scan_plain(*ins)
    _k6_close(y, yp)
    _k6_close(h, hp)


@pytest.mark.parametrize("N", [16, 32, 64])
def test_k6_other_state_sizes_and_batches_match_plain(cuda, N):
    """Jamba's d_state 16 and the sizes between, at batch 3 with a
    ragged tail, B and C read as strided views of one (B, S, 2N) tensor
    (as an fp32 layer hands them)."""
    xh, _, _, log_a, h0 = _k6_inputs(cuda, 150, 4, 64, N, seed=N, B=3)
    bc = torch.randn(3, 150, 2 * N, device=cuda)
    B_, C_ = torch.split(bc, N, dim=-1)
    y, h = ssd_scan(xh, B_, C_, log_a, h0)
    yp, hp = ssd_scan_plain(xh, B_, C_, log_a, h0)
    _k6_close(y, yp)
    _k6_close(h, hp)


def test_k6_strong_decay_stays_finite(cuda):
    """log_a = -30 a step: every exponent is <= 0, so the decays
    underflow to 0 and nothing overflows."""
    H, P, N = K6_SHAPE
    xh, B_, C_, _, h0 = _k6_inputs(cuda, 200, H, P, N, seed=5)
    log_a = torch.full((1, 200, H), -30.0, device=cuda)
    y, h = ssd_scan(xh, B_, C_, log_a, h0)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    yp, hp = ssd_scan_plain(xh, B_, C_, log_a, h0)
    _k6_close(y, yp)
    _k6_close(h, hp)


def test_k6_refuses_what_it_does_not_take(cuda):
    xh, B_, C_, log_a, h0 = _k6_inputs(cuda, 70, 2, 64, 16)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan(xh.cpu(), B_, C_, log_a, h0)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(xh, B_.double(), C_, log_a, h0)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan(xh, B_, C_[:, :-1], log_a, h0)
    with pytest.raises(ValueError, match="head size"):
        ssd_scan(xh[..., :32], B_, C_, log_a, h0[:, :, :32])
    with pytest.raises(ValueError, match="state size"):
        ssd_scan(xh, B_[..., :8], C_[..., :8], log_a, h0[..., :8])
    with pytest.raises(ValueError, match="contiguous last axis"):
        ssd_scan(xh.transpose(2, 3).contiguous().transpose(2, 3), B_, C_,
                 log_a, h0)
    with pytest.raises(ValueError, match="h0 must be contiguous"):
        ssd_scan(xh, B_, C_, log_a, h0.transpose(2, 3).contiguous()
                 .transpose(2, 3))
    with pytest.raises(ValueError, match="no backward"):
        ssd_scan(xh.requires_grad_(), B_, C_, log_a, h0)
    assert ssd_scan.launches == before


def _k6_mixer(cuda):
    """The reduced Jamba's Mamba mixer on the card in fp32 (2 heads of
    64, d_state 16) and an input of 70 tokens (a ragged tail)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import ssm
    cfg = get_reduced_config("jamba-1.5-large-398b").model
    p = ssm.init_mamba(cfg, cfg.ssm, torch.float32, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(0))
    x = torch.randn(2, 70, cfg.d_model, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    return ssm, cfg, p, x


def test_mamba_forward_without_a_gradient_launches_k6(cuda):
    """No gradient required: one K6 call a layer, on the prompt
    unpadded; the output and the states equal the plain loop's (the
    same call with a gradient required) within K6_TOL."""
    ssm, cfg, p, x = _k6_mixer(cuda)
    before = ssd_scan.launches
    with torch.no_grad():
        out, st = ssm.mamba_forward(cfg, cfg.ssm, p, x, None)
    assert ssd_scan.launches == before + 1
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    out_p, st_p = ssm.mamba_forward(cfg, cfg.ssm, pg, x, None)
    assert ssd_scan.launches == before + 1
    _k6_close(out, out_p.detach())
    for k in st:
        _k6_close(st[k], st_p[k].detach())


def test_mamba_forward_with_a_gradient_runs_the_plain_loop(cuda,
                                                           monkeypatch):
    """Weights that require a gradient (training): the plain loop over
    chunks runs, K6's counter stays, and the backward reaches every
    weight with finite gradients."""
    ssm, cfg, p, x = _k6_mixer(cuda)
    p = {k: v.requires_grad_() for k, v in p.items()}
    chunks = []

    def plain(*a, **k):
        chunks.append(a[0].shape[1])
        return mamba_ssd_chunked(*a, **k)

    monkeypatch.setattr(ssd_ref, "mamba_ssd_chunked", plain)
    before = ssd_scan.launches
    out, _ = ssm.mamba_forward(cfg, cfg.ssm, p, x, None)
    out.square().mean().backward()
    torch.cuda.synchronize()
    assert ssd_scan.launches == before and chunks == [128]
    for k, v in p.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
