"""The port's RWKV-6 against the JAX package on the same parameters
(the reduced rwkv6-1.6b: 2 layers, d_model 64, head size 16, fp32, from
the reference's ``init_params`` through ``from_jax_params``): the time
mix with the kernel path off and on (the JAX side runs its Pallas kernel
in interpret mode), the one-token step, the channel mix, the group norm,
and the whole model's prefill states and greedy decode. fp32 at
atol/rtol 1e-4, as tests/test_torch_model.py; one bf16 case, which runs
JAX's mixed-dtype promotion, within bf16 rounding. Then Mamba (the
reduced jamba-1.5-large-398b's mixer: d_model 64, 2 SSD heads of 64,
state 16, conv 4): the causal conv with and without carry, the chunked
SSD, ``mamba_forward`` at lengths on and off the chunk, 8 exact steps
after a prefill, the fresh states, and the conv history's dtype."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.launch import steps as jax_steps
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.parallel import NO_MESH
from repro_torch.configs import get_reduced_config
from repro_torch.kernels.ssd_scan import mamba_ssd_chunked
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.convert import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "rwkv6-1.6b"
PROMPT, DECODE_STEPS = 13, 4          # 13: not a multiple of the chunk


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _rng(seed):
    return np.random.default_rng(seed)


def _cfgs(use_kernel=False, dtype="float32"):
    jcfg, tcfg = jax_reduced(ARCH), get_reduced_config(ARCH)
    out = []
    for c in (jcfg, tcfg):
        out.append(c.replace(train=dataclasses.replace(
            c.train, use_rwkv_kernel=use_kernel, compute_dtype=dtype)))
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.PRNGKey(0), jax_reduced(ARCH))


@pytest.fixture(scope="module")
def layer0(jax_params):
    """The first layer's mixer parameters, in both layouts; u made
    non-zero so the bonus term is exercised."""
    jp = jax.tree.map(lambda a: a[0], jax_params["blocks"]["pos0"]["mixer"])
    jp["u"] = jnp.asarray(_rng(11).standard_normal(jp["u"].shape) * 0.5,
                          jnp.float32)
    return jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


def _state(seed, B, d, H, hs):
    rng = _rng(seed)
    f = np.float32
    return {"S": (rng.standard_normal((B, H, hs, hs)) * 0.1).astype(f),
            "shift_tm": rng.standard_normal((B, d)).astype(f),
            "shift_cm": rng.standard_normal((B, d)).astype(f)}


# ---------------------------------------------------------------------------
# the blocks of one layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_jax(layer0, use_kernel, with_state):
    jp, tp = layer0
    m = get_reduced_config(ARCH).model
    jm = jax_reduced(ARCH).model
    H, hs = m.d_model // m.ssm.head_size, m.ssm.head_size
    x = _rng(1).standard_normal((2, PROMPT, m.d_model)).astype(np.float32)
    st = _state(2, 2, m.d_model, H, hs) if with_state else None
    jst = ({k: jnp.asarray(st[k]) for k in ("S", "shift_tm")}
           if with_state else None)
    tst = ({k: torch.from_numpy(st[k]) for k in ("S", "shift_tm")}
           if with_state else None)
    jout, jnew = jax_ssm.rwkv6_time_mix(jm, jm.ssm, jp, jnp.asarray(x), jst,
                                        use_kernel=use_kernel)
    tout, tnew = ssm.rwkv6_time_mix(m, m.ssm, tp, torch.from_numpy(x), tst,
                                    use_kernel=use_kernel)
    _close(tout, jout)
    _close(tnew["S"], jnew["S"])
    _close(tnew["shift_tm"], jnew["shift_tm"])


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_kernel_path_hands_the_model_layout(layer0, monkeypatch,
                                                     with_state):
    """With use_kernel the time mix gives the WKV scan its (B, S, H, hs)
    projections and (B, H, hs, hs) state as they are (no fold copy) and
    takes y back in that layout; the result still equals the JAX time
    mix's."""
    jp, tp = layer0
    m = get_reduced_config(ARCH).model
    jm = jax_reduced(ARCH).model
    H, hs = m.d_model // m.ssm.head_size, m.ssm.head_size
    x = _rng(3).standard_normal((2, PROMPT, m.d_model)).astype(np.float32)
    st = _state(4, 2, m.d_model, H, hs) if with_state else None
    seen = []

    def spy(r, k, v, log_w, s0, u=None, *, chunk):
        seen.append((r.shape, r.data_ptr(), s0.shape, u.shape))
        y, sT = ssm_rwkv6_scan(r, k, v, log_w, s0, u, chunk=chunk)
        seen.append(y.shape)
        return y, sT
    ssm_rwkv6_scan = ssm.rwkv6_scan_shard
    monkeypatch.setattr(ssm, "rwkv6_scan_shard", spy)
    tst = ({k: torch.from_numpy(st[k]) for k in ("S", "shift_tm")}
           if with_state else None)
    tout, tnew = ssm.rwkv6_time_mix(m, m.ssm, tp, torch.from_numpy(x), tst,
                                    use_kernel=True)
    Sp = PROMPT + (-PROMPT) % 16
    assert seen[0][0] == (2, Sp, H, hs) and seen[0][2] == (2, H, hs, hs)
    assert seen[0][3] == (H, hs) and seen[1] == (2, Sp, H, hs)
    jst = ({k: jnp.asarray(st[k]) for k in ("S", "shift_tm")}
           if with_state else None)
    jout, jnew = jax_ssm.rwkv6_time_mix(jm, jm.ssm, jp, jnp.asarray(x), jst,
                                        use_kernel=True)
    _close(tout, jout)
    _close(tnew["S"], jnew["S"])


def test_time_mix_step_matches_jax(layer0):
    jp, tp = layer0
    m = get_reduced_config(ARCH).model
    jm = jax_reduced(ARCH).model
    H, hs = m.d_model // m.ssm.head_size, m.ssm.head_size
    st = _state(3, 2, m.d_model, H, hs)
    for step in range(3):
        x = _rng(4 + step).standard_normal((2, 1, m.d_model)).astype(
            np.float32)
        jout, jst = jax_ssm.rwkv6_time_mix_step(
            jm, jm.ssm, jp, jnp.asarray(x),
            {k: jnp.asarray(st[k]) for k in ("S", "shift_tm")})
        tout, tst = ssm.rwkv6_time_mix_step(
            m, m.ssm, tp, torch.from_numpy(x),
            {k: torch.from_numpy(st[k]) for k in ("S", "shift_tm")})
        _close(tout, jout)
        _close(tst["S"], jst["S"])
        _close(tst["shift_tm"], jst["shift_tm"])
        st = {k: np.array(v) for k, v in jst.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(layer0, with_state):
    jp, tp = layer0
    d = get_reduced_config(ARCH).model.d_model
    x = _rng(6).standard_normal((2, 7, d)).astype(np.float32)
    prev = _rng(7).standard_normal((2, d)).astype(np.float32)
    jout, jcm = jax_ssm.rwkv6_channel_mix(
        jp, jnp.asarray(x),
        {"shift_cm": jnp.asarray(prev)} if with_state else None)
    tout, tcm = ssm.rwkv6_channel_mix(
        tp, torch.from_numpy(x),
        {"shift_cm": torch.from_numpy(prev)} if with_state else None)
    _close(tout, jout)
    _close(tcm, jcm)


def test_groupnorm_matches_jax():
    y = (_rng(8).standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    s = _rng(9).standard_normal(64).astype(np.float32)
    _close(ssm._rwkv_groupnorm(torch.from_numpy(y), torch.from_numpy(s), 4),
           jax_ssm._rwkv_groupnorm(jnp.asarray(y), jnp.asarray(s), 4))


def test_chunked_matches_sequential_recurrence(layer0):
    """rwkv6_chunked (the plain prefill path) against the exact
    one-token recurrence applied token by token."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_ref
    _, tp = layer0
    rng = _rng(10)
    B, S, H, hs = 2, 32, 4, 16
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hs))
                                .astype(np.float32)) for _ in range(3))
    lw = -torch.exp(torch.from_numpy(rng.standard_normal((B, S, H, hs))
                                     .astype(np.float32)) - 1)
    s0 = torch.zeros(B, H, hs, hs)
    y, sT = ssm.rwkv6_chunked(r, k, v, lw, tp["u"], s0, 16)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, hs)
    yr, sTr = rwkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                        s0.reshape(B * H, hs, hs),
                        tp["u"].expand(B, H, hs).reshape(B * H, hs))
    torch.testing.assert_close(y, yr.reshape(B, H, S, hs).transpose(1, 2),
                               **TOL)
    torch.testing.assert_close(sT, sTr.reshape(B, H, hs, hs), **TOL)


# ---------------------------------------------------------------------------
# the reduced model: prefill logits and states, greedy decode steps
# ---------------------------------------------------------------------------

def _check_states(tstates, jstates, n_layers):
    assert len(tstates) == n_layers
    jmix = jstates["pos0"]["mixer"]
    for li, st in enumerate(tstates):
        _close(st["mixer"]["S"], jmix["S"][li])
        _close(st["mixer"]["shift_tm"], jmix["shift_tm"][li])
        _close(st["shift_cm"], jstates["pos0"]["shift_cm"][li])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_jax(jax_params, use_kernel):
    jcfg, tcfg = _cfgs(use_kernel)
    tparams = from_jax_params(_np(jax_params))
    tokens = _rng(12).integers(0, tcfg.model.vocab_size, (2, PROMPT),
                               dtype=np.int32)
    jstates, jlogits = jax_steps.make_prefill_step(NO_MESH, jcfg)(
        jax_params, {"tokens": jnp.asarray(tokens)})
    tstates, tlogits = steps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    _check_states(tstates, jstates, tcfg.model.num_layers)
    jdecode = jax_steps.make_decode_step(NO_MESH, jcfg, 2)
    tdecode = steps.make_decode_step(tcfg, 2)
    for _ in range(DECODE_STEPS):
        tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
        assert np.array_equal(tok, tlogits[:, -1].argmax(-1).numpy())
        jstates, jlogits = jdecode(jax_params, jstates,
                                   jnp.asarray(tok)[:, None])
        tstates, tlogits = tdecode(tparams, tstates,
                                   torch.from_numpy(tok)[:, None])
        _close(tlogits, jlogits)
    _check_states(tstates, jstates, tcfg.model.num_layers)


def test_init_states_match_jax():
    jcfg, tcfg = _cfgs()
    jstates = jax_model.init_states(NO_MESH, jcfg, 3, 8)
    tstates = M.init_states(tcfg, 3, 8, device="cpu")
    jmix = jstates["pos0"]["mixer"]
    for st in tstates:
        assert set(st) == {"mixer", "shift_cm"}
        assert set(st["mixer"]) == {"S", "shift_tm"}
        for t, j in ((st["mixer"]["S"], jmix["S"]),
                     (st["mixer"]["shift_tm"], jmix["shift_tm"]),
                     (st["shift_cm"], jstates["pos0"]["shift_cm"])):
            assert tuple(t.shape) == j.shape[1:]
            assert t.dtype == torch.float32 and j.dtype == jnp.float32
            assert not t.any()


def test_decode_from_init_states_matches_jax(jax_params):
    jcfg, tcfg = _cfgs()
    tparams = from_jax_params(_np(jax_params))
    jstates = jax_model.init_states(NO_MESH, jcfg, 2, 8)
    tstates = M.init_states(tcfg, 2, 8, device="cpu")
    jdecode = jax_steps.make_decode_step(NO_MESH, jcfg, 2)
    tdecode = steps.make_decode_step(tcfg, 2)
    tok = np.array([3, 77], np.int32)
    for _ in range(3):
        jstates, jlogits = jdecode(jax_params, jstates,
                                   jnp.asarray(tok)[:, None])
        tstates, tlogits = tdecode(tparams, tstates,
                                   torch.from_numpy(tok)[:, None])
        _close(tlogits, jlogits)
        tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
    _check_states(tstates, jstates, tcfg.model.num_layers)


def test_bf16_promotes_as_jax_does(jax_params):
    """bf16 compute: ``w0``, ``w_lora_*`` and ``u`` are bf16 after the
    cast, the LoRA product takes an fp32 ``xw`` (fp32 @ bf16 -> fp32 in
    JAX), and a decode from init_states lerps bf16 activations with fp32
    shift states, so its projections run in fp32. Prefill, then a decode
    from fresh states, within bf16 rounding of the logits' scale."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tparams = M.cast_floats(from_jax_params(_np(jax_params)), torch.bfloat16)
    assert tparams["layers"][0]["mixer"]["w_lora_a"].dtype == torch.bfloat16
    tokens = _rng(13).integers(0, tcfg.model.vocab_size, (2, PROMPT),
                               dtype=np.int32)
    _, jlogits = jax_steps.make_prefill_step(NO_MESH, jcfg)(
        jax_params, {"tokens": jnp.asarray(tokens)})
    _, tlogits = steps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    scale = float(np.abs(np.asarray(jlogits, np.float32)).max())
    bf16 = dict(atol=4e-2 * scale, rtol=0)
    _close(tlogits, jlogits, bf16)

    jstates = jax_model.init_states(NO_MESH, jcfg, 2, 8)
    tstates = M.init_states(tcfg, 2, 8, device="cpu")
    tok = np.array([5, 9], np.int32)
    jstates, jlogits = jax_steps.make_decode_step(NO_MESH, jcfg, 2)(
        jax_params, jstates, jnp.asarray(tok)[:, None])
    tstates, tlogits = steps.make_decode_step(tcfg, 2)(
        tparams, tstates, torch.from_numpy(tok)[:, None])
    assert tlogits.dtype == torch.bfloat16
    # the first step's shifts were fp32 zeros; its new shifts are bf16
    assert tstates[0]["mixer"]["shift_tm"].dtype == torch.bfloat16
    assert jstates["pos0"]["mixer"]["shift_tm"].dtype == jnp.bfloat16
    _close(tlogits, jlogits, bf16)


def test_mixed_dtype_matmul_promotes():
    a = torch.ones(2, 3, dtype=torch.float32)
    b = torch.ones(3, 4, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        a @ b                      # why ssm._mm exists
    assert ssm._mm(a, b).dtype == torch.float32
    assert ssm._mm(b.T, a.T).dtype == torch.float32
    assert ssm._mm(b.T, b).dtype == torch.bfloat16


def test_port_init_params_has_the_reference_tree(jax_params):
    tparams = M.init_params(get_reduced_config(ARCH), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    conv = from_jax_params(_np(jax_params))
    assert len(tparams["layers"]) == len(conv["layers"]) == 2
    for a, b in zip(tparams["layers"], conv["layers"]):
        assert set(a) == set(b) == {"norm1", "norm2", "mixer"}
        assert {k: tuple(v.shape) for k, v in a["mixer"].items()} == \
            {k: tuple(v.shape) for k, v in b["mixer"].items()}
    assert conv["layers"][1]["mixer"]["w0"].shape == (4, 16)
    assert conv["layers"][1]["mixer"]["u"].shape == (4, 16)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def mamba():
    """(reference config, port config, the reference's init_mamba params
    as numpy, the same as tensors); dt_bias and a_log spread so the
    decays differ per head."""
    jm, tm = jax_reduced(JAMBA).model, get_reduced_config(JAMBA).model
    jp = _np(jax_ssm.init_mamba(jax.random.PRNGKey(3), jm, jm.ssm,
                                jnp.float32))
    jp["conv_b"] = (_rng(30).standard_normal(jp["conv_b"].shape) * 0.1) \
        .astype(np.float32)
    jp["d_skip"] = _rng(31).standard_normal(jp["d_skip"].shape) \
        .astype(np.float32)
    return jm, tm, jp, {k: torch.tensor(v) for k, v in jp.items()}


def _mamba_state(tm, B, seed):
    di, H, N = ssm.mamba_dims(tm, tm.ssm)
    W = tm.ssm.d_conv
    rng = _rng(seed)
    f = np.float32
    return {"h": (rng.standard_normal((B, H, ssm.P_HEAD, N)) * 0.3)
            .astype(f),
            "conv": rng.standard_normal((B, W - 1, di)).astype(f),
            "conv_bc": rng.standard_normal((B, W - 1, 2 * N)).astype(f)}


def _both(st):
    if st is None:
        return None, None
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_depthwise_conv_matches_jax(with_carry):
    rng = _rng(32)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    carry = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_carry else None
    ref = jax_ssm._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if carry is None else jnp.asarray(carry))
    out = ssm._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if carry is None else torch.from_numpy(carry))
    _close(out, ref)


@pytest.mark.parametrize("chunk", [16, 64])
def test_mamba_ssd_chunked_matches_jax(chunk):
    rng = _rng(33)
    B, S, H, P, N = 2, 128, 3, 64, 16
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    log_a = -rng.uniform(0.0, 0.5, (B, S, H)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.3).astype(np.float32)
    yr, hr = jax_ssm.mamba_ssd_chunked(*(jnp.asarray(t) for t in
                                         (xh, Bm, Cm, log_a, h0)), chunk)
    y, h = mamba_ssd_chunked(*(torch.from_numpy(t) for t in
                               (xh, Bm, Cm, log_a, h0)), chunk)
    _close(y, yr)
    _close(h, hr)


@pytest.mark.parametrize("S", [64, 70])       # 70: a padded tail
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_matches_jax(mamba, S, with_state):
    jm, tm, jp, tp = mamba
    x = _rng(34).standard_normal((2, S, tm.d_model)).astype(np.float32)
    jst, tst = _both(_mamba_state(tm, 2, 35) if with_state else None)
    jout, jnew = jax_ssm.mamba_forward(jm, jm.ssm, jp, jnp.asarray(x), jst)
    tout, tnew = ssm.mamba_forward(tm, tm.ssm, tp, torch.from_numpy(x), tst)
    _close(tout, jout)
    assert set(tnew) == set(jnew) == {"h", "conv", "conv_bc"}
    for k in jnew:
        assert tuple(tnew[k].shape) == jnew[k].shape
        _close(tnew[k], jnew[k])


def test_mamba_steps_after_prefill_match_jax(mamba):
    """A prefill of 70 tokens, then 8 exact one-token steps: every
    step's output and the states it returns."""
    jm, tm, jp, tp = mamba
    rng = _rng(36)
    x = rng.standard_normal((2, 70, tm.d_model)).astype(np.float32)
    _, jst = jax_ssm.mamba_forward(jm, jm.ssm, jp, jnp.asarray(x), None)
    _, tst = ssm.mamba_forward(tm, tm.ssm, tp, torch.from_numpy(x), None)
    jstep = jax.jit(jax_ssm.mamba_step, static_argnums=(0, 1))
    for _ in range(8):
        xs = rng.standard_normal((2, 1, tm.d_model)).astype(np.float32)
        jout, jst = jstep(jm, jm.ssm, jp, jnp.asarray(xs), jst)
        tout, tst = ssm.mamba_step(tm, tm.ssm, tp, torch.from_numpy(xs), tst)
        _close(tout, jout)
        for k in jst:
            _close(tst[k], jst[k])


def test_mamba_conv_history_dtype_follows_the_reference(mamba):
    """Fresh states hold fp32 conv histories; a bf16 step or prefill
    leaves them in bf16, as the reference's do, and h stays fp32."""
    jm, tm, jp, tp = mamba
    fresh = ssm.init_mamba_state(tm, tm.ssm, 2, device="cpu")
    jfresh = jax_ssm.init_mamba_state(jm, jm.ssm, 2)
    for k in jfresh:
        assert tuple(fresh[k].shape) == jfresh[k].shape
        assert fresh[k].dtype == torch.float32 and not fresh[k].any()
    p16 = M.cast_floats(tp, torch.bfloat16)
    x = torch.from_numpy(_rng(37).standard_normal(
        (2, 1, tm.d_model)).astype(np.float32)).to(torch.bfloat16)
    _, st = ssm.mamba_step(tm, tm.ssm, p16, x, fresh)
    _, jst = jax_ssm.mamba_step(
        jm, jm.ssm, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp),
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jfresh)
    for k in jst:
        assert str(st[k].dtype)[6:] == str(jst[k].dtype), k
    _, st2 = ssm.mamba_forward(tm, tm.ssm, p16, x.repeat(1, 5, 1), st)
    assert st2["conv"].dtype == torch.bfloat16
    assert st2["h"].dtype == torch.float32


def test_port_init_mamba_has_the_reference_tree(mamba):
    jm, tm, jp, _ = mamba
    tp = ssm.init_mamba(tm, tm.ssm, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert tp[k].dtype == torch.float32
    for k in ("a_log", "dt_bias", "norm", "conv_b"):
        np.testing.assert_allclose(
            tp[k].numpy(), _np(jax_ssm.init_mamba(
                jax.random.PRNGKey(3), jm, jm.ssm, jnp.float32))[k],
            rtol=1e-6, atol=1e-7)
