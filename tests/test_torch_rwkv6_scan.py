"""The port's RWKV-6 WKV scan (K4's plain version on CPU tensors)
against the JAX package's ``rwkv6_scan`` (its Pallas kernel in interpret
mode) and its exact sequential ``rwkv6_ref``, on the same numpy inputs,
at the reference's kernel-test tolerance (atol/rtol 1e-4, fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_ref as jax_ref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_scan
from repro_torch.kernels.rwkv6_scan import (rwkv6_ref, rwkv6_scan,
                                            rwkv6_scan_plain)

TOL = dict(atol=1e-4, rtol=1e-4)
# tests/test_kernels.py's cases: BH, S, hs, chunk, with_u
CASES = [
    (4, 128, 64, 32, True), (2, 64, 32, 16, False),
    (3, 96, 64, 32, True), (1, 250, 64, 64, True),
]


def _inputs(BH, S, hs, with_u, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    r = rng.standard_normal((BH, S, hs)).astype(f)
    k = (rng.standard_normal((BH, S, hs)) * 0.5).astype(f)
    v = rng.standard_normal((BH, S, hs)).astype(f)
    lw = -np.exp(rng.standard_normal((BH, S, hs)) - 1.0).astype(f)
    s0 = (rng.standard_normal((BH, hs, hs)) * 0.1).astype(f)
    u = (rng.standard_normal((BH, hs)) * 0.5).astype(f) if with_u else None
    return r, k, v, lw, s0, u


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close(port, ref, what=""):
    """assert_allclose at TOL; a failure names ``what`` was compared and
    the element that differs most, with both values."""
    p, r = port.numpy(), np.asarray(ref)
    err = np.abs(p.astype(np.float64) - r)
    at = tuple(int(i) for i in np.unravel_index(np.argmax(err), err.shape))
    np.testing.assert_allclose(
        p, r, **TOL, err_msg=f"{what}: max abs diff {err.max()} at {at}: "
                             f"port {p[at]}, reference {r[at]}")


@pytest.mark.parametrize("case", CASES)
def test_scan_matches_jax_kernel_and_ref(case):
    BH, S, hs, chunk, with_u = case
    arrays = _inputs(BH, S, hs, with_u)
    y, sT = rwkv6_scan(*_torch(arrays), chunk=chunk)
    jargs = [None if a is None else jnp.asarray(a) for a in arrays]
    for name, (jy, jsT) in (("JAX rwkv6_scan", jax_scan(*jargs,
                                                        chunk=chunk)),
                            ("JAX rwkv6_ref", jax_ref(*jargs))):
        _close(y, jy, f"y against {name}")
        _close(sT, jsT, f"final state against {name}")


@pytest.mark.parametrize("case", CASES)
def test_sequential_ref_matches_jax_ref(case):
    BH, S, hs, _, with_u = case
    arrays = _inputs(BH, S, hs, with_u, seed=1)
    y, sT = rwkv6_ref(*_torch(arrays))
    jy, jsT = jax_ref(*[None if a is None else jnp.asarray(a)
                        for a in arrays])
    _close(y, jy)
    _close(sT, jsT)


def test_strong_decay_stays_finite():
    """log_w = -30: exp(480) if the decay were factored; the chunked
    form keeps every exponent <= 0."""
    BH, S, hs = 2, 64, 32
    ones = torch.ones(BH, S, hs)
    y, sT = rwkv6_scan(ones, ones, ones, torch.full((BH, S, hs), -30.0),
                       torch.zeros(BH, hs, hs), None, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    jy, jsT = jax_scan(*(jnp.asarray(t.numpy()) for t in
                         (ones, ones, ones, torch.full((BH, S, hs), -30.0),
                          torch.zeros(BH, hs, hs))), None, chunk=16)
    _close(y, jy)
    _close(sT, jsT)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_plain_scan_equals_sequential_for_any_chunk(chunk):
    r, k, v, lw, s0, _ = _torch(_inputs(3, 128, 16, False, seed=2))
    y, sT = rwkv6_scan_plain(r, k, v, lw, s0, chunk=chunk)
    yr, sTr = rwkv6_ref(r, k, v, lw, s0)
    torch.testing.assert_close(y, yr, **TOL)
    torch.testing.assert_close(sT, sTr, **TOL)


def test_plain_scan_refuses_a_ragged_chunk():
    t = torch.zeros(1, 20, 16)
    with pytest.raises(ValueError, match="multiple"):
        rwkv6_scan_plain(t, t, t, t, torch.zeros(1, 16, 16), chunk=16)


@pytest.mark.parametrize("S", [250, 5, 8, 33])
def test_wrapper_pads_the_tail(S):
    """S not a multiple of the chunk (and S < 8): the zero-padded tail
    leaves y[:S] and the final state as the unpadded recurrence has
    them."""
    arrays = _inputs(2, S, 32, True, seed=S)
    y, sT = rwkv6_scan(*_torch(arrays), chunk=64)
    assert y.shape == (2, S, 32)
    jy, jsT = jax_scan(*[jnp.asarray(a) for a in arrays], chunk=64)
    _close(y, jy)
    _close(sT, jsT)


def test_bonus_u_is_the_diagonal_term():
    """u given adds sum(r k u) v to y and leaves the state alone."""
    r, k, v, lw, s0, u = _torch(_inputs(2, 40, 16, True, seed=4))
    y0, s_0 = rwkv6_scan(r, k, v, lw, s0, None, chunk=16)
    y1, s_1 = rwkv6_scan(r, k, v, lw, s0, u, chunk=16)
    torch.testing.assert_close(s_0, s_1)
    diag = (r * k * u[:, None, :]).sum(-1, keepdim=True) * v
    torch.testing.assert_close(y1, y0 + diag, **TOL)
    yr, _ = rwkv6_ref(r, k, v, lw, s0, u)
    torch.testing.assert_close(y1, yr, **TOL)


def test_cpu_calls_launch_nothing():
    before = rwkv6_scan.launches
    r, k, v, lw, s0, _ = _torch(_inputs(1, 16, 16, False))
    rwkv6_scan(r, k, v, lw, s0, chunk=16)
    assert rwkv6_scan.launches == before


# the model's layout: (B, S, H, hs) inputs, (B, H, hs, hs) state, u (H, hs)
CASES_4D = [
    # B, S, H, hs, chunk, with_u
    (2, 64, 2, 32, 16, True),      # S a multiple of the chunk
    (1, 50, 3, 16, 16, True),      # padded tail
    (2, 40, 2, 64, 64, False),     # chunk cut to max(8, S)
    (3, 7, 2, 16, 16, True),       # S < 8
]


def _inputs4(B, S, H, hs, with_u, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rng.standard_normal((B, S, H, hs)).astype(f)
               for _ in range(3))
    k = k * f(0.5)
    lw = -np.exp(rng.standard_normal((B, S, H, hs)) - 1.0).astype(f)
    s0 = (rng.standard_normal((B, H, hs, hs)) * 0.1).astype(f)
    u = (rng.standard_normal((H, hs)) * 0.5).astype(f) if with_u else None
    return r, k, v, lw, s0, u


def _fold(a):
    B, S, H, hs = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(
        B * H, S, hs)


@pytest.mark.parametrize("case", CASES_4D)
def test_model_layout_matches_jax_scan(case):
    """The (B, S, H, hs) entry equals the JAX scan on the folded
    (B * H, S, hs) inputs, with padding and the bonus u."""
    B, S, H, hs, chunk, with_u = case
    r, k, v, lw, s0, u = _inputs4(B, S, H, hs, with_u, seed=S + hs)
    y, sT = rwkv6_scan(*_torch((r, k, v, lw, s0, u)), chunk=chunk)
    assert y.shape == (B, S, H, hs) and sT.shape == (B, H, hs, hs)
    ju = None if u is None else jnp.asarray(np.tile(u, (B, 1)))
    jy, jsT = jax_scan(*(jnp.asarray(_fold(a)) for a in (r, k, v, lw)),
                       jnp.asarray(s0.reshape(B * H, hs, hs)), ju,
                       chunk=chunk)
    _close(y.transpose(1, 2).reshape(B * H, S, hs), jy)
    _close(sT.reshape(B * H, hs, hs), jsT)


def test_model_layout_reads_strided_views():
    """r, k, v, log_w as head slices of one fused projection give what
    their contiguous copies give."""
    B, S, H, hs = 2, 32, 2, 16
    rng = np.random.default_rng(5)
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, 4 * H, hs)).astype(np.float32))
    r, k, v, lw = (fused[:, :, j * H:(j + 1) * H] for j in range(4))
    lw = -torch.exp(lw - 1.0)
    s0 = torch.zeros(B, H, hs, hs)
    assert not r.is_contiguous()
    y, sT = rwkv6_scan(r, k, v, lw, s0, chunk=16)
    yc, sTc = rwkv6_scan(*(t.contiguous() for t in (r, k, v, lw)), s0,
                         chunk=16)
    torch.testing.assert_close(y, yc)
    torch.testing.assert_close(sT, sTc)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_entry_equals_the_scan_on_the_same_heads(n_shards):
    """``rwkv6_scan_shard`` on each shard's heads (B, S, H / n, hs), with
    ``u`` sliced to them, equals ``rwkv6_scan`` on all heads, restricted
    to those heads, bit for bit; it launches nothing on the CPU, and
    refuses a ``u`` that does not hold the shard's heads."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_shard
    B, S, H, hs = 2, 40, 4, 16
    rng = np.random.default_rng(7)
    f = np.float32
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hs))
                                .astype(f)) for _ in range(3))
    lw = torch.from_numpy(-np.exp(rng.standard_normal((B, S, H, hs))
                                  - 1.0).astype(f))
    s0 = torch.from_numpy((rng.standard_normal((B, H, hs, hs)) * 0.1)
                          .astype(f))
    u = torch.from_numpy((rng.standard_normal((H, hs)) * 0.5).astype(f))
    y, sT = rwkv6_scan(r, k, v, lw, s0, u, chunk=16)
    n = H // n_shards
    before = rwkv6_scan.launches
    for i in range(n_shards):
        sl = slice(i * n, (i + 1) * n)
        parts = [t[:, :, sl] for t in (r, k, v, lw)]
        ys, sTs = rwkv6_scan_shard(*parts, s0[:, sl], u[sl], chunk=16)
        torch.testing.assert_close(ys, y[:, :, sl], rtol=0, atol=0)
        torch.testing.assert_close(sTs, sT[:, sl], rtol=0, atol=0)
    assert rwkv6_scan.launches == before
    if n_shards == 1:
        return
    with pytest.raises(ValueError, match="does not hold the shard's heads"):
        rwkv6_scan_shard(*(t[:, :, :n] for t in (r, k, v, lw)),
                         s0[:, :n], u, chunk=16)
