"""The Mamba-2 chunked SSD scan's wrapper (K6, ``kernels/ssd_scan``) on
CPU tensors, where it runs the plain loop and launches nothing: equal to
``mamba_ssd_chunked`` on the zero-padded inputs at every length, to the
exact sequential recurrence, causal across the ragged tail; and
``mamba_forward`` on the CPU keeps the plain loop. The kernel itself is
tested on the card (``tests/test_torch_kernels_gpu.py``)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_reduced_config
from repro_torch.kernels.ssd_scan import (mamba_ssd_chunked, ssd_scan,
                                          ssd_scan_plain)
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import ssm

#: fp32 against an fp64 recurrence: the chunked form sums in another
#: order (about 1e-6 of outputs of order 1-10 here)
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(B, S, H, N, seed=0, P=64):
    """xh, B_, C_, log_a (<= 0), h0 (non-zero), fp32, drawn as a Mamba-2
    layer hands them: B and C of order 1, dt-scaled inputs of order 0.1,
    decays per step of exp(0 .. -0.5)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return tuple(torch.from_numpy(a.astype(f)) for a in (
        rng.standard_normal((B, S, H, P)) * 0.1,
        rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
        -rng.uniform(0.0, 0.5, (B, S, H)),
        rng.standard_normal((B, H, P, N)) * 0.3))


def _sequential(xh, B_, C_, log_a, h0):
    """h_t = exp(a_t) h_{t-1} + x_t^T B_t, y_t = h_t C_t, in fp64."""
    xh, B_, C_, log_a, h = (t.double() for t in (xh, B_, C_, log_a, h0))
    ys = []
    for t in range(xh.shape[1]):
        h = h * torch.exp(log_a[:, t])[:, :, None, None] + \
            xh[:, t, :, :, None] * B_[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
def test_wrapper_on_cpu_is_the_plain_loop_on_padded_inputs(S):
    xh, B_, C_, log_a, h0 = _inputs(2, S, 3, 16, seed=S)
    before = ssd_scan.launches
    y, h = ssd_scan(xh, B_, C_, log_a, h0)
    assert ssd_scan.launches == before == 0
    pad = (-S) % 64
    yp, hp = mamba_ssd_chunked(
        F.pad(xh, (0, 0, 0, 0, 0, pad)),
        *(F.pad(t, (0, 0, 0, pad)) for t in (B_, C_, log_a)), h0, 64)
    assert y.shape == xh.shape and h.shape == h0.shape
    assert torch.equal(y, yp[:, :S]) and torch.equal(h, hp)


@pytest.mark.parametrize("S", [1, 63, 130])
@pytest.mark.parametrize("N", [16, 128])
def test_plain_scan_is_the_sequential_recurrence(S, N):
    xh, B_, C_, log_a, h0 = _inputs(1, S, 2, N, seed=10 + S)
    y, h = ssd_scan_plain(xh, B_, C_, log_a, h0)
    yr, hr = _sequential(xh, B_, C_, log_a, h0)
    torch.testing.assert_close(y.double(), yr, **TOL)
    torch.testing.assert_close(h.double(), hr, **TOL)


def test_the_padded_tail_reaches_back_nowhere():
    """y over the first 70 tokens equals the first 70 rows of a run over
    all 128: the zero-padded tail changes nothing before it."""
    xh, B_, C_, log_a, h0 = _inputs(1, 128, 2, 16, seed=3)
    y_all, _ = ssd_scan(xh, B_, C_, log_a, h0)
    y70, h70 = ssd_scan(xh[:, :70], B_[:, :70], C_[:, :70], log_a[:, :70],
                        h0)
    torch.testing.assert_close(y70, y_all[:, :70], **TOL)
    _, h_ref = _sequential(xh[:, :70], B_[:, :70], C_[:, :70],
                           log_a[:, :70], h0)
    torch.testing.assert_close(h70.double(), h_ref, **TOL)


@pytest.mark.parametrize("S", [64, 70])
def test_mamba_forward_on_cpu_runs_the_plain_loop(S, monkeypatch):
    """On CPU tensors ``mamba_forward`` hands the prompt unpadded to K6's
    wrapper, which pads it to the chunk and runs ``mamba_ssd_chunked``:
    nothing is launched, and the output equals the same call with a
    gradient required (the plain loop taken directly)."""
    cfg = get_reduced_config("jamba-1.5-large-398b").model
    p = ssm.init_mamba(cfg, cfg.ssm, torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    calls = []

    def plain(*a, **k):
        calls.append(a[0].shape[1])
        return mamba_ssd_chunked(*a, **k)

    monkeypatch.setattr(ssd_ref, "mamba_ssd_chunked", plain)
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        out, st = ssm.mamba_forward(cfg, cfg.ssm, p, x, None)
    assert calls == [S + (-S) % 64]
    assert out.shape == x.shape and ssd_ops.ssd_scan.launches == 0
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    out_g, st_g = ssm.mamba_forward(cfg, cfg.ssm, pg, x, None)
    assert calls == [S + (-S) % 64] * 2
    assert torch.equal(out, out_g.detach())
    for k in st:
        assert torch.equal(st[k], st_g[k].detach()), k
