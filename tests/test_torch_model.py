"""The port's model against the JAX package on the same parameters:
layers, attention (plain, q-blocked, windowed ring-buffer decode) and
the reduced Qwen3-8B prefill + decode steps, with the flash path off
and on (the JAX side runs its Pallas kernel in interpret mode).
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


def test_unported_layer_kinds_name_their_roadmap_item():
    for arch, what in (("rwkv6-1.6b", "models/ssm.py"),
                       ("mixtral-8x7b", "models/moe.py"),
                       ("jamba-1.5-large-398b", "models/ssm.py")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
            M.init_params(get_reduced_config(arch), device="cpu",
                          generator=torch.Generator().manual_seed(0))
        assert what in str(e.value)


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
