"""The port's model against the JAX package on the same parameters:
layers, attention (plain, q-blocked, windowed ring-buffer decode), the
reduced Qwen3-8B prefill + decode steps, with the flash path off and on
(the JAX side runs its Pallas kernel in interpret mode), and the reduced
MoE and Mamba models (Mixtral, Jamba, Kimi-K2) with the router's loss.
Everything in fp32, at atol/rtol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attn
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.parallel import NO_MESH
from repro_torch.configs import get_reduced_config
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen3-8b"
PROMPT, DECODE_STEPS = 12, 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **TOL)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm):
    jcfg = dataclasses.replace(jax_reduced(ARCH).model, norm=norm)
    tcfg = dataclasses.replace(get_reduced_config(ARCH).model, norm=norm)
    x = _rng(0).standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": _rng(1).standard_normal(64).astype(np.float32),
         "bias": _rng(2).standard_normal(64).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    ref = jax_layers.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in
                                       p.items()}, jnp.asarray(x))
    out = layers.apply_norm(tcfg, {k: torch.from_numpy(v) for k, v in
                                   p.items()}, torch.from_numpy(x))
    _close(out, ref)


def test_rms_norm_simple_and_softcap():
    x = _rng(3).standard_normal((2, 5, 4, 16)).astype(np.float32)
    s = _rng(4).standard_normal(16).astype(np.float32)
    _close(layers.rms_norm_simple(torch.from_numpy(x), torch.from_numpy(s)),
           jax_layers.rms_norm_simple(jnp.asarray(x), jnp.asarray(s)))
    _close(layers.softcap(torch.from_numpy(x * 40), 30.0),
           jax_layers.softcap(jnp.asarray(x * 40), 30.0))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = _rng(5).standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(3, 12, dtype=np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "sq_relu"])
def test_apply_ffn(act):
    jcfg = dataclasses.replace(jax_reduced(ARCH).model, ffn_activation=act)
    tcfg = dataclasses.replace(get_reduced_config(ARCH).model,
                               ffn_activation=act)
    p = _np(jax_layers.init_ffn(jax.random.PRNGKey(1), jcfg, 64, 96,
                                jnp.float32))
    x = _rng(6).standard_normal((2, 5, 64)).astype(np.float32)
    _close(layers.apply_ffn(tcfg, {k: torch.tensor(v)
                                   for k, v in p.items()},
                            torch.from_numpy(x)),
           jax_layers.apply_ffn(jcfg, p, jnp.asarray(x)))


def test_truncated_normal_is_truncated_then_scaled():
    g = torch.Generator().manual_seed(0)
    w = layers.dense_init(256, 64, torch.float32, device="cpu",
                          generator=g)
    assert w.shape == (256, 64)
    assert float(w.abs().max()) <= 2.0 / 16.0
    assert 0.8 / 16 < float(w.std()) < 0.9 / 16     # std of N(0,1) | +-2


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attention_setup(window):
    jacfg = jax_reduced(ARCH)
    att = dataclasses.replace(jacfg.model.attention, sliding_window=window)
    p = _np(jax_attn.init_attention(jax.random.PRNGKey(2), jacfg.model, att,
                                    jnp.float32))
    tatt = dataclasses.replace(get_reduced_config(ARCH).model.attention,
                               sliding_window=window)
    return att, tatt, p, {k: torch.tensor(v) for k, v in p.items()}


def test_attention_forward_q_blocked():
    """S > block_q: the reference's scan over q blocks is a loop here."""
    att, tatt, jp, tp = _attention_setup(None)
    x = _rng(7).standard_normal((2, 16, 64)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    ref = jax.jit(jax_attn.attention_forward, static_argnums=1,
                  static_argnames=("window", "causal", "block_q"))(
        jp, att, jnp.asarray(x), jnp.asarray(pos), window=None,
        causal=True, block_q=4)
    out = attn.attention_forward(tp, tatt, torch.from_numpy(x),
                                 torch.from_numpy(pos), window=None,
                                 causal=True, block_q=4)
    _close(out, ref)


def test_windowed_decode_ring_buffer():
    """A window shorter than the prompt: the prefill cache keeps the last
    Sc positions rolled into ring order, and decode overwrites slots in
    place (the reference rebuilds the cache functionally)."""
    window, S = 4, 10
    att, tatt, jp, tp = _attention_setup(window)
    x = _rng(8).standard_normal((2, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jout, jkv = jax.jit(jax_attn.attention_forward, static_argnums=1,
                        static_argnames=("window", "causal", "return_kv"))(
        jp, att, jnp.asarray(x), jnp.asarray(pos), window=window,
        causal=True, return_kv=True)
    tout, tkv = attn.attention_forward(tp, tatt, torch.from_numpy(x),
                                       torch.from_numpy(pos), window=window,
                                       causal=True, return_kv=True)
    _close(tout, jout)
    jc = jax_model._cache_from_prefill(jkv, window, 16)
    tc = M._cache_from_prefill(tkv, window, 16)
    jdecode = jax.jit(jax_attn.attention_decode, static_argnums=1,
                      static_argnames="window")
    for step in range(3):
        xs = _rng(20 + step).standard_normal((2, 1, 64)).astype(np.float32)
        jo, jc = jdecode(jp, att, jnp.asarray(xs), jc, window=window)
        to, tc = attn.attention_decode(tp, tatt, torch.from_numpy(xs), tc,
                                       window=window)
        _close(to, jo)
        _close(tc.k, jc.k)
        assert tc.index == int(jc.index) == S + step + 1


@pytest.mark.parametrize("window,S,max_seq,n_steps", [
    (4, 6, 16, 7),        # a ring of 4 slots wraps twice while decoding
    (None, 6, 8, 6),      # a full cache of 8 slots wraps past its end
], ids=["window", "no_window"])
def test_decode_position_on_the_device_across_a_ring_wrap(window, S, max_seq,
                                                           n_steps):
    """The cache's position is a 0-d int64 tensor on the cache's device,
    from which decode computes the RoPE position, the ring slot, the K/V
    write and the mask; across the ring's wrap every output, both caches
    and the advanced position equal the reference's, and the step leaves
    the position it was given as it was."""
    att, tatt, jp, tp = _attention_setup(window)
    x = _rng(30).standard_normal((2, S, 64)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    _, jkv = jax.jit(jax_attn.attention_forward, static_argnums=1,
                     static_argnames=("window", "causal", "return_kv"))(
        jp, att, jnp.asarray(x), jnp.asarray(pos), window=window,
        causal=True, return_kv=True)
    _, tkv = attn.attention_forward(tp, tatt, torch.from_numpy(x),
                                    torch.from_numpy(pos), window=window,
                                    causal=True, return_kv=True)
    jc = jax_model._cache_from_prefill(jkv, window, max_seq)
    tc = M._cache_from_prefill(tkv, window, max_seq)
    jdecode = jax.jit(jax_attn.attention_decode, static_argnums=1,
                      static_argnames="window")
    Sc = tc.k.shape[1]
    assert S + n_steps > Sc + 1          # the ring wraps in the decode
    for step in range(n_steps):
        assert isinstance(tc.index, torch.Tensor)
        assert tc.index.dim() == 0 and tc.index.dtype == torch.int64
        assert tc.index.device == tc.k.device
        given = tc.index
        xs = _rng(40 + step).standard_normal((2, 1, 64)).astype(np.float32)
        jo, jc = jdecode(jp, att, jnp.asarray(xs), jc, window=window)
        to, tc = attn.attention_decode(tp, tatt, torch.from_numpy(xs), tc,
                                       window=window)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert int(given) == S + step
        assert int(tc.index) == int(jc.index) == S + step + 1


# ---------------------------------------------------------------------------
# the reduced Qwen3-8B: prefill logits, KV states, decode steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.PRNGKey(0), jax_reduced(ARCH))


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_and_decode_match_jax(jax_params, use_flash):
    jcfg = jax_reduced(ARCH)
    jcfg = jcfg.replace(train=dataclasses.replace(
        jcfg.train, use_flash_kernel=use_flash))
    tcfg = get_reduced_config(ARCH)
    tcfg = tcfg.replace(train=dataclasses.replace(
        tcfg.train, use_flash_kernel=use_flash))
    tparams = from_jax_params(_np(jax_params))
    max_seq = PROMPT + DECODE_STEPS + 2
    tokens = _rng(9).integers(0, tcfg.model.vocab_size, (2, PROMPT),
                              dtype=np.int32)

    jstates, jlogits = jax_steps.make_prefill_step(
        NO_MESH, jcfg, max_seq=max_seq)(jax_params,
                                        {"tokens": jnp.asarray(tokens)})
    tstates, tlogits = steps.make_prefill_step(tcfg, max_seq=max_seq)(
        tparams, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)

    def check_states():
        jcache = jstates["pos0"]["mixer"]
        assert len(tstates) == tcfg.model.num_layers
        for li, st in enumerate(tstates):
            _close(st["mixer"].k, jcache.k[li])
            _close(st["mixer"].v, jcache.v[li])
            assert st["mixer"].index == int(jcache.index[li])

    check_states()
    jdecode = jax_steps.make_decode_step(NO_MESH, jcfg, 2)
    tdecode = steps.make_decode_step(tcfg, 2)
    for _ in range(DECODE_STEPS):
        tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
        jstates, jlogits = jdecode(jax_params, jstates,
                                   jnp.asarray(tok)[:, None])
        tstates, tlogits = tdecode(tparams, tstates,
                                   torch.from_numpy(tok)[:, None])
        _close(tlogits, jlogits)
    check_states()


# ---------------------------------------------------------------------------
# the reduced MoE and Mamba models: prefill logits and states, 4 decode
# steps, the router's aux loss
# ---------------------------------------------------------------------------

MOE_ARCHS = ["mixtral-8x7b", "jamba-1.5-large-398b", "kimi-k2-1t-a32b"]


def _close_layer_states(tstates, jstates, period):
    """The port's per-layer states against the reference's (stacked over
    periods: layer li is entry li // period of pos{li % period})."""
    for li, st in enumerate(tstates):
        ref = jax.tree.map(lambda a, i=li // period: a[i],
                           jstates[f"pos{li % period}"])
        if isinstance(st["mixer"], attn.KVCache):
            _close(st["mixer"].k, ref["mixer"].k)
            _close(st["mixer"].v, ref["mixer"].v)
            assert st["mixer"].index == int(ref["mixer"].index)
        else:
            assert set(st["mixer"]) == set(ref["mixer"])
            for k in ref["mixer"]:
                _close(st["mixer"][k], ref["mixer"][k])


def _prefill_and_decode_match(jcfg, tcfg):
    """A prompt of 70 (not a multiple of Mamba's chunk of 64, and past a
    reduced window of 64) with room to decode, then 4 greedy decode
    steps: logits and every layer's states against the reference's.
    Returns the port's states after the last step."""
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(_np(jp))
    period = tcfg.model.pattern_period
    prompt, max_seq = 70, 70 + DECODE_STEPS + 2
    tokens = _rng(10).integers(0, tcfg.model.vocab_size, (2, prompt),
                               dtype=np.int32)
    jstates, jlogits = jax_steps.make_prefill_step(
        NO_MESH, jcfg, max_seq=max_seq)(jp, {"tokens": jnp.asarray(tokens)})
    tstates, tlogits = steps.make_prefill_step(tcfg, max_seq=max_seq)(
        tp, {"tokens": torch.from_numpy(tokens)})
    _close(tlogits, jlogits)
    assert len(tstates) == tcfg.model.num_layers
    _close_layer_states(tstates, jstates, period)
    jdecode = jax_steps.make_decode_step(NO_MESH, jcfg, 2)
    tdecode = steps.make_decode_step(tcfg, 2)
    for _ in range(DECODE_STEPS):
        tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1), np.int32)
        jstates, jlogits = jdecode(jp, jstates, jnp.asarray(tok)[:, None])
        tstates, tlogits = tdecode(tp, tstates,
                                   torch.from_numpy(tok)[:, None])
        _close(tlogits, jlogits)
    _close_layer_states(tstates, jstates, period)
    return tstates


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_mamba_models_prefill_and_decode_match_jax(arch):
    """Reduced Mixtral (MoE, window), Jamba (Mamba + attention, MoE
    every other layer) and Kimi-K2 (MoE, dh 112 reduced to 16), MoE
    dropless."""
    _prefill_and_decode_match(jax_reduced(arch), get_reduced_config(arch))


@pytest.mark.parametrize("use_flash", [False, True])
def test_gemma2_prefill_and_decode_match_jax(use_flash):
    """Reduced Gemma-2-9B (local window 64 and global layers alternating,
    attention softcap 50, final logit softcap 30, tied embeddings, GeGLU)
    with the flash path off and on (the reference's Pallas kernel in
    interpret mode): the 70-token prompt wraps the local layer's ring
    cache of 64, the global layer's cache holds every position."""
    jcfg, tcfg = jax_reduced("gemma2-9b"), get_reduced_config("gemma2-9b")
    jcfg, tcfg = (c.replace(train=dataclasses.replace(
        c.train, use_flash_kernel=use_flash)) for c in (jcfg, tcfg))
    assert tcfg.model.window_pattern == (64, None)
    states = _prefill_and_decode_match(jcfg, tcfg)
    assert [st["mixer"].k.shape[1] for st in states] == \
        [64, 70 + DECODE_STEPS + 2]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_forward_returns_the_summed_router_loss(arch):
    """``forward`` returns (hidden, states, aux), aux the MoE layers'
    load-balance losses summed, as the reference's does; a model without
    MoE returns 0."""
    jcfg, tcfg = jax_reduced(arch), get_reduced_config(arch)
    jp = jax_init_params(jax.random.PRNGKey(1), jcfg)
    tokens = _rng(11).integers(0, 128, (2, 16), dtype=np.int32)
    jh, _, jaux = jax_model.forward(NO_MESH, jcfg, jp,
                                    tokens=jnp.asarray(tokens))
    th, states, taux = M.forward(tcfg, from_jax_params(_np(jp)),
                                 tokens=torch.from_numpy(tokens))
    assert states is None
    _close(th, jh)
    _close(taux, jaux)
    assert float(taux) > 0
    qcfg = get_reduced_config(ARCH)
    qp = M.init_params(qcfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    _, _, aux = M.forward(qcfg, qp, tokens=torch.from_numpy(tokens))
    assert float(aux) == 0.0


def test_jamba_init_states_match_jax():
    """Fresh states of the hybrid: KV caches for the attention layer,
    fp32 zero Mamba states elsewhere, each of the reference's shape."""
    jcfg, tcfg = (jax_reduced("jamba-1.5-large-398b"),
                  get_reduced_config("jamba-1.5-large-398b"))
    jstates = jax_model.init_states(NO_MESH, jcfg, 2, 8)
    tstates = M.init_states(tcfg, 2, 8, device="cpu")
    assert len(tstates) == tcfg.model.num_layers
    for li, st in enumerate(tstates):
        ref = jstates[f"pos{li % tcfg.model.pattern_period}"]["mixer"]
        if tcfg.model.layer_pattern[li] == "attn":
            assert tuple(st["mixer"].k.shape) == ref.k.shape[1:]
            continue
        assert set(st["mixer"]) == set(ref)
        for k, t in st["mixer"].items():
            assert tuple(t.shape) == ref[k].shape[1:]
            assert t.dtype == torch.float32 and ref[k].dtype == jnp.float32
            assert not t.any()


def test_jamba_cut_below_one_period_serves():
    """A depth that is not a whole number of periods (Jamba's card path
    keeps positions 0-4 of its 8): init, prefill and decode need no
    ``n_periods``."""
    import dataclasses as dc
    acfg = get_reduced_config("jamba-1.5-large-398b")
    acfg = acfg.replace(model=dc.replace(acfg.model, num_layers=5))
    with pytest.raises(AssertionError):
        acfg.model.n_periods
    p = M.init_params(acfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert [("ffn" in lp and "router" in lp["ffn"]) for lp in
            p["layers"]] == [False, True, False, True, False]
    assert "wq" in p["layers"][4]["mixer"]
    tokens = torch.from_numpy(_rng(12).integers(0, 128, (2, 9),
                                                dtype=np.int32))
    states, logits = steps.make_prefill_step(acfg, max_seq=12)(
        p, {"tokens": tokens})
    states, logits = steps.make_decode_step(acfg, 2)(
        p, states, logits[:, -1].argmax(-1).to(torch.int32)[:, None])
    assert logits.shape == (2, 1, 128) and torch.isfinite(logits).all()


def test_cast_floats_once():
    p = M.init_params(get_reduced_config(ARCH), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    cast = M.cast_floats(p, torch.bfloat16)
    assert cast["layers"][1]["mixer"]["wq"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16
    assert p["embed"].dtype == torch.float32


def test_decode_from_init_states_matches_jax(jax_params):
    """Decoding from fresh (empty) caches: init_states' layout, dtype and
    zero cursor match the reference's."""
    jcfg, tcfg = jax_reduced(ARCH), get_reduced_config(ARCH)
    tparams = from_jax_params(_np(jax_params))
    jstates = jax_model.init_states(NO_MESH, jcfg, 2, 8)
    tstates = M.init_states(tcfg, 2, 8, device="cpu")
    assert [st["mixer"].k.shape for st in tstates] == \
        [jstates["pos0"]["mixer"].k.shape[1:]] * tcfg.model.num_layers
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
