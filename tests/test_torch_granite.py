"""Granite-4.0-H (``granite-4.0-h-small``, the port's hybrid of Mamba-2
layers beside a routed MoE with a shared expert and muP multipliers)
against the benchmark's plain float32 reference
(``portbench/reference/granitemoehybrid.py``: the SSD in its quadratic
masked form, experts computed on their routed tokens only), at a small
size on the CPU in float32: d 64, one whole period of 10 layers (nine
Mamba-2, one attention), 8 experts top-3 beside a shared expert of 32,
d_state 16. Both sides take the weights the benchmark draws
(``portbench/weights_granitemoehybrid.py``).

Tolerance, everywhere: 1e-5 relative and absolute, on logits of order
0.05-0.3 (vocabulary 128 at d 64, divided by 16), and 1-5 where a test
leaves the division out. Both sides compute in float32; the port's SSD
sums chunk by chunk (chunk 64, the prompt padded to it) where the
reference sums the quadratic form, and the routed sum gathers in
another order, so the two differ by float32 rounding compounded over
ten layers: 1e-7 to 3.4e-6 here, and the bound leaves room for another
BLAS's order. A mechanism left out or misplaced
moves the logits by 1e-2 or more (each feature's test checks that it
does)."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights_granitemoehybrid as W  # noqa: E402
from portbench.reference import granitemoehybrid as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: the multipliers and the shared expert, each the test switches alone
FEATURES = ("shared", "embedding_multiplier", "residual_multiplier",
            "logits_scaling")
#: the published values of the switches (the reference's "off" is 1.0
#: for a multiplier, no shared expert for the shared expert)
PUBLISHED = {"embedding_multiplier": 12.0, "residual_multiplier": 0.22,
             "logits_scaling": 16.0}
MAX_SEQ = 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(on=FEATURES):
    """(the port's ``ArchConfig``, the reference's configuration dict) of
    Granite-4.0-H at the small size, with the features in ``on``."""
    a = get_config("granite-4.0-h-small")
    m = a.model
    mult = {k: (v if k in on else None) for k, v in PUBLISHED.items()}
    model = dataclasses.replace(
        m, d_model=64, d_ff=24, vocab_size=128,
        attention=dataclasses.replace(m.attention, n_heads=4, n_kv_heads=2,
                                      d_head=16, softmax_scale=0.125),
        moe=dataclasses.replace(m.moe, num_experts=8, top_k=3,
                                d_ff_expert=24,
                                d_ff_shared=32 if "shared" in on else None),
        ssm=dataclasses.replace(m.ssm, d_state=16),
        max_position_embeddings=4096, **mult)
    acfg = a.replace(model=model, train=dataclasses.replace(
        a.train, param_dtype="float32", compute_dtype="float32"))
    cfg = {"family": "granitemoehybrid", "hidden_size": 64,
           "intermediate_size": 24, "vocab_size": 128,
           "num_hidden_layers": 10,
           "layer_types": ["attention" if k == "attn" else k
                           for k in m.layer_pattern],
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "attention_multiplier": 0.125,
           "num_local_experts": 8, "num_experts_per_tok": 3,
           "shared_intermediate_size": 32 if "shared" in on else None,
           "capacity_factor": 1.25, "mamba_expand": 2, "mamba_d_head": 64,
           "mamba_n_heads": 2, "mamba_n_groups": 1, "mamba_d_state": 16,
           "mamba_d_conv": 4, "rms_norm_eps": 1e-5,
           "torch_dtype": "float32",
           **{k: (mult[k] if mult[k] is not None else 1.0)
              for k in PUBLISHED}}
    return acfg, cfg


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 128, n).astype(np.int32)


def _served(acfg, params, prompt, n):
    """The port's greedy tokens and their logits: the prefill, then
    ``n - 1`` decode steps through its states."""
    prefill = steps.make_prefill_step(acfg, max_seq=MAX_SEQ)
    decode = steps.make_decode_step(acfg, 1)
    states, lg = prefill(params, {"tokens": torch.as_tensor(prompt[None])})
    logits, toks = [lg[0, -1]], [int(lg[0, -1].argmax())]
    for _ in range(n - 1):
        states, lg = decode(params, states,
                            torch.tensor([[toks[-1]]], dtype=torch.int32))
        logits.append(lg[0, -1])
        toks.append(int(lg[0, -1].argmax()))
    return np.array(toks), torch.stack(logits)


def test_the_config_is_as_published():
    m = get_config("granite-4.0-h-small").model
    assert (m.num_layers, m.d_model, m.vocab_size) == (40, 4096, 100352)
    assert m.layer_pattern.count("attn") == 1 and len(m.layer_pattern) == 10
    assert [i for i in range(40) if m.layer_pattern[i % 10] == "attn"] \
        == [5, 15, 25, 35]
    assert (m.moe.num_experts, m.moe.top_k, m.moe.d_ff_expert,
            m.moe.d_ff_shared) == (72, 10, 768, 1536)
    assert (m.ssm.kind, m.ssm.d_state, m.ssm.expand) == ("mamba", 128, 2)
    att = m.attention
    assert (att.n_heads, att.n_kv_heads, att.d_head, att.use_rope,
            att.softmax_scale) == (32, 8, 128, False, 0.0078125)
    assert (m.embedding_multiplier, m.residual_multiplier, m.logits_scaling,
            m.norm_eps, m.tie_embeddings) == (12.0, 0.22, 16.0, 1e-5, True)


@pytest.mark.parametrize("plen", [70, 128])
def test_prefill_logits_match_the_reference(plen):
    acfg, cfg = small()
    params = W.draw_params(cfg, 3, "cpu")
    prompt = _prompt(plen, plen)
    _, logits = _served(acfg, params, prompt, 1)
    want = ref.served_logits(cfg, 3, [(prompt, np.zeros(1, np.int64))],
                             "cpu")[0]
    torch.testing.assert_close(logits, want, **TOL)


def test_decode_through_the_states_matches_the_full_forward():
    """Prefill, then 6 decode steps through the KV cache and the Mamba
    states (conv histories and SSM state), against the reference's
    forward over prompt and served tokens whole."""
    acfg, cfg = small()
    params = W.draw_params(cfg, 4, "cpu")
    prompt = _prompt(61, 7)
    toks, logits = _served(acfg, params, prompt, 7)
    want = ref.served_logits(cfg, 4, [(prompt, toks)], "cpu")[0]
    torch.testing.assert_close(logits, want, **TOL)


@pytest.mark.parametrize("feature", FEATURES)
def test_each_feature_alone_matches_the_reference(feature):
    """The shared expert and each multiplier switched on alone (the
    others off: 1.0 in the reference, None in the port) match, and the
    feature moves the logits well past the tolerance."""
    acfg, cfg = small(on=(feature,))
    params = W.draw_params(cfg, 5, "cpu")
    prompt = _prompt(40, 11)
    toks, logits = _served(acfg, params, prompt, 3)
    want = ref.served_logits(cfg, 5, [(prompt, toks)], "cpu")[0]
    torch.testing.assert_close(logits, want, **TOL)
    _, off_cfg = small(on=())
    if feature == "shared":
        off = ref.served_logits(off_cfg, 5, [(prompt, toks)], "cpu")[0]
    else:    # the same weights, the multiplier at 1.0
        off = ref.served_logits(dict(cfg, **{feature: 1.0}), 5,
                                [(prompt, toks)], "cpu")[0]
    assert (off - want).abs().max() > 1e-2


def test_drops_are_counted_only_while_a_profiler_records():
    """At capacity factor 0.5 the prompt's 300 assignments a layer meet
    8 experts of 20 slots, so at least 140 a layer are dropped."""
    from torch.profiler import ProfilerActivity, profile
    acfg, cfg = small()
    acfg = acfg.replace(model=dataclasses.replace(
        acfg.model, moe=dataclasses.replace(acfg.model.moe,
                                            capacity_factor=0.5)))
    params = W.draw_params(cfg, 6, "cpu")
    prompt = _prompt(100, 3)
    moe_lib.DROPS.reset()
    _served(acfg, params, prompt, 2)
    assert moe_lib.DROPS.read() == (0, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _served(acfg, params, prompt, 2)
    dropped, routed = moe_lib.DROPS.read()
    moe_lib.DROPS.reset()
    # every layer routes the prompt's 100 tokens to 3 experts; the decode
    # step is dropless and not counted
    assert routed == 10 * 100 * 3
    C = moe_lib._capacity(acfg.model.moe, 100, False)
    assert C == 20
    assert 10 * (300 - 8 * C) <= dropped < routed
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("model.mamba") == 9 * 2
