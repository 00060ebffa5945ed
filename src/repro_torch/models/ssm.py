"""Recurrent blocks: RWKV-6 ("Finch", data-dependent per-channel decay).

The reference's ``models/ssm.py`` also holds Mamba (SSD); that half is
not ported yet (ROADMAP.md, Queue 1).

Prefill uses the chunked formulation: with ``use_kernel`` the WKV scan
of every chunk runs in the hand-written kernel K4
(``kernels/rwkv6_scan``), otherwise in ``rwkv6_chunked`` below. All
decay exponents are differences of inclusive cumulative log decays and
therefore <= 0. Single-token decode uses the exact recurrence.

Mixed dtypes follow JAX's promotion, which the reference relies on: a
bf16 activation against an fp32 operand computes in fp32 (``fp32 @
bf16`` is an fp32 product in JAX, where torch's ``@`` refuses mixed
dtypes; see ``_mm``). So the LoRA decay path (``xw`` cast to fp32) runs
in fp32, and a decode from ``init_states`` (fp32 shift states) runs its
lerps and projections in fp32.

Shapes: x (B, S, d). State: {"S": (B, H, K, V) fp32, "shift_tm": (B, d),
"shift_cm": (B, d)}.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.layers import dense_init

NEG_INF = -1e30


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX would promote the pair to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shift right by one along seq; slot 0 filled from carry (or zeros).
    An fp32 carry promotes the result to fp32, as in JAX."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


# =========================================================================
# RWKV-6
# =========================================================================

def init_rwkv6(cfg: ModelConfig, ssm: SSMConfig, dtype, *, device,
               generator: torch.Generator) -> dict:
    """The reference draws ``w0``, ``w_lora_*`` and ``u`` in fp32 and
    casts them to the compute dtype on every call; here every tensor is
    drawn in fp32 and cast to ``dtype`` as it is drawn."""
    d, f = cfg.d_model, cfg.d_ff
    hs = ssm.head_size
    H = d // hs
    kw = dict(device=device, generator=generator)
    lora = 64

    def full(val):
        return torch.full((d,), val, dtype=dtype, device=device)

    return {
        # time-mix
        "mu_w": full(0.5), "mu_r": full(0.5), "mu_k": full(0.5),
        "mu_v": full(0.5), "mu_g": full(0.5),
        "w0": torch.linspace(-6.0, -2.0, d, device=device)
        .reshape(H, hs).to(dtype),
        "w_lora_a": dense_init(d, lora, dtype, scale=0.01, **kw),
        "w_lora_b": dense_init(lora, d, dtype, scale=0.01, **kw),
        "u": torch.zeros((H, hs), dtype=dtype, device=device),   # bonus
        "wr": dense_init(d, d, dtype, **kw),
        "wk": dense_init(d, d, dtype, **kw),
        "wv": dense_init(d, d, dtype, **kw),
        "wg": dense_init(d, d, dtype, **kw),
        "wo": dense_init(d, d, dtype, **kw),
        "ln_x": torch.ones((d,), dtype=dtype, device=device),
        # channel-mix
        "mu_k_cm": full(0.5), "mu_r_cm": full(0.5),
        "wk_cm": dense_init(d, f, dtype, **kw),
        "wv_cm": dense_init(f, d, dtype, **kw),
        "wr_cm": dense_init(d, d, dtype, **kw),
    }


def _rwkv6_rkvgw(p, x, xprev, H, hs):
    """Projections + data-dependent decay. Returns fp32 (B,S,H,hs) r, k,
    v, log_w and the gate g."""
    B, S, d = x.shape

    def lerp(mu):
        return x + (xprev - x) * mu

    xw, xr, xk, xv, xg = (lerp(p[m]) for m in
                          ("mu_w", "mu_r", "mu_k", "mu_v", "mu_g"))
    w_raw = p["w0"].reshape(-1) + _mm(
        torch.tanh(_mm(xw.float(), p["w_lora_a"])), p["w_lora_b"])
    log_w = -torch.exp(w_raw)                             # (B,S,d), < 0
    r = _mm(xr, p["wr"]).float()
    k = _mm(xk, p["wk"]).float()
    v = _mm(xv, p["wv"]).float()
    g = F.silu(_mm(xg, p["wg"]))

    def rs(t):
        return t.reshape(B, S, H, hs)
    return rs(r), rs(k), rs(v), g, rs(log_w)


def rwkv6_chunked(r, k, v, log_w, u, state, chunk: int):
    """Chunked WKV in plain PyTorch. r,k,v,log_w: (B,S,H,hs) fp32; u:
    (H,hs); state: (B,H,K,V). Returns y (B,S,H,hs), new state."""
    B, S, H, hs = r.shape
    assert S % chunk == 0, (S, chunk)
    idx = torch.arange(chunk, device=r.device)
    tri = idx[None, :] < idx[:, None]                    # strict i < t
    eye = torch.eye(chunk, device=r.device)
    S_st = state
    ys = []
    for c0 in range(0, S, chunk):
        # (B, H, Lc, hs)
        rb, kb, vb, lw = (t[:, c0:c0 + chunk].transpose(1, 2)
                          for t in (r, k, v, log_w))
        cum = torch.cumsum(lw, dim=2)                     # inclusive
        cum_tm1 = cum - lw
        # D[t,i,c] = exp(cum_{t-1,c} - cum_{i,c}) for i<t  (<=0 exponent)
        dlog = cum_tm1[:, :, :, None, :] - cum[:, :, None, :, :]
        dlog = torch.where(tri[None, None, :, :, None], dlog,
                           torch.full_like(dlog, NEG_INF))
        A = torch.einsum("bhtc,bhic,bhtic->bhti", rb, kb, torch.exp(dlog))
        diag = torch.sum(rb * kb * u[None, :, None, :], dim=-1)
        A = A + eye[None, None] * diag[:, :, :, None]
        y_intra = torch.einsum("bhti,bhiv->bhtv", A, vb)
        y_inter = torch.einsum("bhtk,bhkv->bhtv", rb * torch.exp(cum_tm1),
                               S_st)
        # state update: decays to end of chunk, all exponents <= 0
        decay_out = torch.exp(cum[:, :, -1:, :] - cum)    # (B,H,Lc,hs)
        S_st = S_st * torch.exp(cum[:, :, -1, :])[..., None] + \
            torch.einsum("bhik,bhiv->bhkv", kb * decay_out, vb)
        ys.append((y_intra + y_inter).transpose(1, 2))
    return torch.cat(ys, dim=1), S_st


def _rwkv_groupnorm(y: torch.Tensor, scale: torch.Tensor, H: int,
                    eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm (GroupNorm with H groups), RWKV convention."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).float()
    mean = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return yh.reshape(B, S, d) * scale.float()


def rwkv6_time_mix(cfg: ModelConfig, ssm: SSMConfig, p: dict,
                   x: torch.Tensor, state: Optional[dict], chunk: int = 16,
                   use_kernel: bool = False
                   ) -> Tuple[torch.Tensor, dict]:
    B, S, d = x.shape
    hs = ssm.head_size
    H = d // hs
    pad = (-S) % chunk
    x_orig = x
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    prev = state["shift_tm"] if state is not None else None
    xprev = _token_shift(x, prev)
    r, k, v, g, log_w = _rwkv6_rkvgw(p, x, xprev, H, hs)
    if pad:  # padded tail must not touch the state: zero adds, zero decay
        valid = (torch.arange(S + pad, device=x.device) < S)[
            None, :, None, None]
        k = k * valid
        v = v * valid
        log_w = log_w * valid
    S0 = state["S"] if state is not None else torch.zeros(
        (B, H, hs, hs), dtype=torch.float32, device=x.device)
    if use_kernel:
        # (B, S, H, hs) in and out: the kernel reads the projections'
        # layout through strides, so nothing is folded or transposed
        y, S_new = rwkv6_scan(r, k, v, log_w, S0, p["u"], chunk=chunk)
    else:
        y, S_new = rwkv6_chunked(r, k, v, log_w, p["u"], S0, chunk)
    y = y[:, :S] if pad else y
    g = g[:, :S] if pad else g
    y = _rwkv_groupnorm(y.reshape(B, S, d), p["ln_x"], H)
    out = _mm(y.to(x.dtype) * g, p["wo"])
    new_state = {"S": S_new, "shift_tm": x_orig[:, -1, :]}
    return out, new_state


def rwkv6_time_mix_step(cfg: ModelConfig, ssm: SSMConfig, p: dict,
                        x: torch.Tensor, state: dict
                        ) -> Tuple[torch.Tensor, dict]:
    """Exact single-token recurrence. x: (B,1,d)."""
    B, _, d = x.shape
    hs = ssm.head_size
    H = d // hs
    xprev = state["shift_tm"][:, None, :]
    r, k, v, g, log_w = _rwkv6_rkvgw(p, x, xprev, H, hs)
    r, k, v, lw = (t[:, 0] for t in (r, k, v, log_w))    # (B,H,hs)
    outer = k[..., :, None] * v[..., None, :]            # (B,H,K,V)
    S0 = state["S"]
    y = torch.einsum("bhk,bhkv->bhv", r,
                     S0 + p["u"][None, :, :, None] * outer)
    S_new = S0 * torch.exp(lw)[..., None] + outer
    y = _rwkv_groupnorm(y.reshape(B, 1, d), p["ln_x"], H)
    out = _mm(y.to(x.dtype) * g, p["wo"])
    return out, {"S": S_new, "shift_tm": x[:, -1, :]}


def rwkv6_channel_mix(p: dict, x: torch.Tensor, state: Optional[dict]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    prev = state["shift_cm"] if state is not None else None
    xprev = _token_shift(x, prev)
    xk = x + (xprev - x) * p["mu_k_cm"]
    xr = x + (xprev - x) * p["mu_r_cm"]
    kk = F.relu(_mm(xk, p["wk_cm"]))
    out = torch.sigmoid(_mm(xr, p["wr_cm"])) * _mm(kk * kk, p["wv_cm"])
    return out, x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, ssm: SSMConfig, batch: int, *,
                    device) -> dict:
    d = cfg.d_model
    H = d // ssm.head_size
    return {"S": torch.zeros((batch, H, ssm.head_size, ssm.head_size),
                             dtype=torch.float32, device=device),
            "shift_tm": torch.zeros((batch, d), dtype=torch.float32,
                                    device=device),
            "shift_cm": torch.zeros((batch, d), dtype=torch.float32,
                                    device=device)}
