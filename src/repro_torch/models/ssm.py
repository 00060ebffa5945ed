"""Recurrent blocks: RWKV-6 ("Finch", data-dependent per-channel decay)
and Mamba (the SSD formulation).

RWKV-6 prefill uses the chunked formulation: with ``use_kernel`` the WKV scan
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

Every mixer takes its head count from its weights, not from ``d``, so
that a per-shard body over a mesh (``models/model.py``) can hand it one
rank's heads: the projections' columns, the per-head tensors sliced to
those heads, and x whole; RWKV's scan goes through K4's per-shard
entry, whose one shard holds every head without a mesh. The
output projection then yields that rank's partial sum, and the states
hold its heads.

Mamba prefill runs the chunked SSD (chunk 64) in plain PyTorch, as the
reference runs it in einsums outside any Pallas kernel; decode is the
exact one-token recurrence. State: {"h": (B, H, 64, N) fp32, "conv":
(B, W-1, di), "conv_bc": (B, W-1, 2N)}: the conv histories are fp32
zeros from ``init_mamba_state`` and the compute dtype after a prefill or
a step, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_shard
from repro_torch.models.layers import _mm, dense_init, truncated_normal
from repro_torch.parallel import sharding as sh

NEG_INF = -1e30


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
    H = p["wr"].shape[-1] // hs          # this shard's heads (all: d // hs)
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
        y, S_new = rwkv6_scan_shard(r, k, v, log_w, S0, p["u"],
                                    chunk=chunk)
    else:
        y, S_new = rwkv6_chunked(r, k, v, log_w, p["u"], S0, chunk)
    y = y[:, :S] if pad else y
    g = g[:, :S] if pad else g
    y = _rwkv_groupnorm(y.reshape(B, S, H * hs), p["ln_x"], H)
    out = _mm(y.to(x.dtype) * g, p["wo"])
    new_state = {"S": S_new, "shift_tm": x_orig[:, -1, :]}
    return out, new_state


def rwkv6_time_mix_step(cfg: ModelConfig, ssm: SSMConfig, p: dict,
                        x: torch.Tensor, state: dict
                        ) -> Tuple[torch.Tensor, dict]:
    """Exact single-token recurrence. x: (B,1,d)."""
    B = x.shape[0]
    hs = ssm.head_size
    H = p["wr"].shape[-1] // hs
    xprev = state["shift_tm"][:, None, :]
    r, k, v, g, log_w = _rwkv6_rkvgw(p, x, xprev, H, hs)
    r, k, v, lw = (t[:, 0] for t in (r, k, v, log_w))    # (B,H,hs)
    outer = k[..., :, None] * v[..., None, :]            # (B,H,K,V)
    S0 = state["S"]
    y = torch.einsum("bhk,bhkv->bhv", r,
                     S0 + p["u"][None, :, :, None] * outer)
    S_new = S0 * torch.exp(lw)[..., None] + outer
    y = _rwkv_groupnorm(y.reshape(B, 1, H * hs), p["ln_x"], H)
    out = _mm(y.to(x.dtype) * g, p["wo"])
    return out, {"S": S_new, "shift_tm": x[:, -1, :]}


def channel_mix_factors(p: dict, x: torch.Tensor,
                        prev: Optional[torch.Tensor]):
    """The channel mix's two factors, the receptance ``sigmoid(xr @
    wr_cm)`` and the value ``relu(xk @ wk_cm)**2 @ wv_cm``, and the last
    position (the next shift state). ``prev``: the shift state or None.
    Over a mesh the value is a partial sum, reduced before the product
    (``models/model.py``)."""
    xprev = _token_shift(x, prev)
    xk = x + (xprev - x) * p["mu_k_cm"]
    xr = x + (xprev - x) * p["mu_r_cm"]
    kk = F.relu(_mm(xk, p["wk_cm"]))
    return (torch.sigmoid(_mm(xr, p["wr_cm"])), _mm(kk * kk, p["wv_cm"]),
            x[:, -1, :])


def rwkv6_channel_mix(p: dict, x: torch.Tensor, state: Optional[dict]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    r, v, last = channel_mix_factors(
        p, x, state["shift_cm"] if state is not None else None)
    return r * v, last


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


# =========================================================================
# Mamba (SSD formulation)
# =========================================================================

P_HEAD = 64  # SSD head size


def mamba_dims(cfg: ModelConfig, ssm: SSMConfig):
    di = ssm.expand * cfg.d_model
    H = di // P_HEAD
    N = ssm.d_state
    return di, H, N


def truncated_conv_init(width: int, channels: int, dtype, *, device,
                        generator: torch.Generator) -> torch.Tensor:
    return truncated_normal((width, channels), 1.0 / width ** 0.5, dtype,
                            device=device, generator=generator)


def init_mamba(cfg: ModelConfig, ssm: SSMConfig, dtype, *, device,
               generator: torch.Generator) -> dict:
    """The reference keeps ``a_log``, ``d_skip`` and ``dt_bias`` in fp32
    and casts them to the compute dtype on every call; here they are
    cast to ``dtype`` once, as every tensor is (see ``init_rwkv6``)."""
    d = cfg.d_model
    di, H, N = mamba_dims(cfg, ssm)
    kw = dict(device=device, generator=generator)

    def vec(t):
        return t.to(device=device, dtype=dtype)

    return {
        "z_proj": dense_init(d, di, dtype, **kw),
        "x_proj": dense_init(d, di, dtype, **kw),
        "bc_proj": dense_init(d, 2 * N, dtype, **kw),
        "dt_proj": dense_init(d, H, dtype, **kw),
        "conv_w": truncated_conv_init(ssm.d_conv, di, dtype, **kw),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "conv_w_bc": truncated_conv_init(ssm.d_conv, 2 * N, dtype, **kw),
        "conv_b_bc": torch.zeros((2 * N,), dtype=dtype, device=device),
        "a_log": vec(torch.log(torch.linspace(1.0, 16.0, H))),
        "d_skip": vec(torch.ones((H,))),
        "dt_bias": vec(torch.log(torch.expm1(torch.linspace(1e-3, 1e-1,
                                                             H)))),
        "norm": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(di, d, dtype, **kw),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, carry: Optional[torch.Tensor]
                           ) -> torch.Tensor:
    """x: (B,S,C); w: (W,C). Left-pad with carry (B,W-1,C) or zeros."""
    W, S = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], W - 1, x.shape[2])) if carry is None
           else carry.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                      # (B, S+W-1, C)
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(out + b)


def mamba_ssd_chunked(xh, B_, C_, log_a, h0, chunk: int):
    """xh: (B,S,H,P) dt-scaled inputs; B_,C_: (B,S,N); log_a: (B,S,H) <=0;
    h0: (B,H,P,N). Returns y (B,S,H,P), h_final. A loop over chunks (the
    reference's scan); every decay exponent is a difference of inclusive
    cumulative log decays, <= 0."""
    S = xh.shape[1]
    assert S % chunk == 0, (S, chunk)
    idx = torch.arange(chunk, device=xh.device)
    tri = idx[None, :] <= idx[:, None]                   # i <= t
    h = h0
    ys = []
    for c0 in range(0, S, chunk):
        xb, Bb, Cb, ab = (t[:, c0:c0 + chunk] for t in (xh, B_, C_, log_a))
        cum = torch.cumsum(ab, dim=1)                     # (B,Lc,H)
        dlog = cum[:, :, None, :] - cum[:, None, :, :]    # [t,i,h]
        dlog = torch.where(tri[None, :, :, None], dlog,
                           torch.full_like(dlog, NEG_INF))
        scores = torch.einsum("btn,bin->bti", Cb, Bb)     # (B,Lc,Lc)
        M = scores[:, :, :, None] * torch.exp(dlog)       # (B,Lc,Lc,H)
        y_intra = torch.einsum("btih,bihp->bthp", M, xb)
        y_inter = torch.einsum("btn,bhpn->bthp", Cb, h) * \
            torch.exp(cum)[..., None]
        decay_out = torch.exp(cum[:, -1:, :] - cum)       # (B,Lc,H)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + \
            torch.einsum("bihp,bin->bhpn", xb * decay_out[..., None], Bb)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _local_dims(p, ssm: SSMConfig):
    """(d_inner, heads, d_state) of the heads ``p`` holds."""
    di = p["x_proj"].shape[-1]
    return di, di // P_HEAD, ssm.d_state


def _mamba_proj(p, x):
    return (_mm(x, p["z_proj"]), _mm(x, p["x_proj"]), _mm(x, p["bc_proj"]),
            _mm(x, p["dt_proj"]))


def _mamba_post(p, y, z, x_heads, B, S, di, eps, norm_group=None):
    """``eps``: the gated RMSNorm's. ``norm_group``: the process group
    over which ``d_inner`` is split (None: this rank holds all of it).
    The gated RMSNorm's mean runs over the whole ``d_inner``, so a shard
    sums its squares and the sums are added across the group."""
    y = y + p["d_skip"][None, None, :, None] * x_heads
    y = y.reshape(B, S, di)
    # gated RMSNorm
    yz = y * F.silu(z.float())
    if norm_group is None:
        var = torch.mean(torch.square(yz), dim=-1, keepdim=True)
    else:
        var = sh.sum_partials(torch.sum(torch.square(yz), dim=-1,
                                        keepdim=True), norm_group) / (
            di * sh.dist.get_world_size(norm_group))
    y = yz * torch.rsqrt(var + eps) * p["norm"].float()
    # the reference casts down to the compute dtype BEFORE the
    # out projection
    return _mm(y.to(p["out_proj"].dtype), p["out_proj"])


def mamba_forward(cfg: ModelConfig, ssm: SSMConfig, p: dict,
                  x: torch.Tensor, state: Optional[dict], chunk: int = 64,
                  norm_group=None) -> Tuple[torch.Tensor, dict]:
    """``norm_group``: see ``_mamba_post``."""
    B, S, d = x.shape
    di, H, N = _local_dims(p, ssm)
    padn = (-S) % chunk
    if padn:
        x = F.pad(x, (0, 0, 0, padn))
    Sp = S + padn
    z, xs_pre, bc_pre, dt = _mamba_proj(p, x)
    cx = state["conv"] if state is not None else None
    cbc = state["conv_bc"] if state is not None else None
    xs = _causal_depthwise_conv(xs_pre, p["conv_w"], p["conv_b"], cx)
    bc = _causal_depthwise_conv(bc_pre, p["conv_w_bc"], p["conv_b_bc"],
                                cbc)
    B_, C_ = torch.split(bc, N, dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,Sp,H)
    if padn:  # padded tail: zero dt kills both decay and state writes
        dt = dt * (torch.arange(Sp, device=x.device) < S)[None, :, None]
    log_a = -torch.exp(p["a_log"])[None, None, :] * dt           # <= 0
    x_heads = xs.reshape(B, Sp, H, P_HEAD).float()
    xh = x_heads * dt[..., None]
    h0 = state["h"] if state is not None else torch.zeros(
        (B, H, P_HEAD, N), dtype=torch.float32, device=x.device)
    y, h = mamba_ssd_chunked(xh, B_.float(), C_.float(), log_a, h0, chunk)
    if padn:
        y, z, x_heads = y[:, :S], z[:, :S], x_heads[:, :S]
        xs_pre, bc_pre = xs_pre[:, :S], bc_pre[:, :S]
    out = _mamba_post(p, y, z, x_heads, B, S, di, cfg.norm_eps,
                      norm_group)
    W = ssm.d_conv

    def hist(carry, pre):
        zpad = x.new_zeros((B, W - 1, pre.shape[-1]))
        full = torch.cat(
            [(carry.to(x.dtype) if carry is not None else zpad), pre], dim=1)
        return full[:, -(W - 1):, :]

    return out, {"h": h, "conv": hist(cx, xs_pre),
                 "conv_bc": hist(cbc, bc_pre)}


def mamba_step(cfg: ModelConfig, ssm: SSMConfig, p: dict, x: torch.Tensor,
               state: dict, norm_group=None) -> Tuple[torch.Tensor, dict]:
    """Exact single-token recurrence. x: (B,1,d)."""
    B = x.shape[0]
    di, H, N = _local_dims(p, ssm)
    z, xs_pre, bc_pre, dt = _mamba_proj(p, x)
    W = ssm.d_conv
    conv_in = torch.cat([state["conv"].to(x.dtype), xs_pre],
                        dim=1)                            # (B, W, di)
    conv_in_bc = torch.cat([state["conv_bc"].to(x.dtype), bc_pre],
                           dim=1)                         # (B, W, 2N)
    xs = F.silu(torch.einsum("bwc,wc->bc", conv_in, p["conv_w"])
                + p["conv_b"])[:, None, :]
    bc = F.silu(torch.einsum("bwc,wc->bc", conv_in_bc, p["conv_w_bc"])
                + p["conv_b_bc"])[:, None, :]
    B_, C_ = torch.split(bc, N, dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]      # (B,H)
    a = torch.exp(-torch.exp(p["a_log"])[None, :] * dt)   # (B,H)
    x_heads = xs.reshape(B, 1, H, P_HEAD).float()
    xdt = x_heads[:, 0] * dt[..., None]                   # (B,H,P)
    h = state["h"] * a[:, :, None, None] + \
        xdt[..., None] * B_[:, 0].float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", C_[:, 0].float(), h)[:, None]
    out = _mamba_post(p, y, z, x_heads, B, 1, di, cfg.norm_eps,
                      norm_group)
    return out, {"h": h, "conv": conv_in[:, -(W - 1):, :],
                 "conv_bc": conv_in_bc[:, -(W - 1):, :]}


def init_mamba_state(cfg: ModelConfig, ssm: SSMConfig, batch: int, *,
                     device) -> dict:
    di, H, N = mamba_dims(cfg, ssm)
    kw = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, H, P_HEAD, N), **kw),
            "conv": torch.zeros((batch, ssm.d_conv - 1, di), **kw),
            "conv_bc": torch.zeros((batch, ssm.d_conv - 1, 2 * N), **kw)}
