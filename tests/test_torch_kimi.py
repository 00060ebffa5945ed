"""Kimi-K2 (``kimi-k2-instruct``: MLA in every layer, a dense first
layer, then a sigmoid-routed MoE beside a shared expert, on a card's
share of the experts) against the benchmark's plain float32 reference
(``portbench/reference/kimi_k2.py``: MLA expanded, no cache, experts
computed on their routed tokens only), at a small size on the CPU in
float32: d 64, 4 heads (q / k 16 + 8 rope, v 16), ranks 24 / 16, three
layers (one dense), 4 experts held of a router of 12, top-3, beside a
shared expert. Both sides take the weights the benchmark draws
(``portbench/weights_kimi_k2.py``).

Tolerance: 1e-5 relative and absolute on logits of order 1. Both sides
compute in float32; the reference ropes in float64 angles, on the
published regrouping of the pairs, and expands MLA where the port's
decode absorbs it, so the two differ by float32 rounding: about 1e-6
here. A mechanism left out or misplaced (the bias, the scaling, the
mscale, the ramp, the dense layer, the held share) moves the logits by
1e-2 or more."""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights_kimi_k2 as W  # noqa: E402
from portbench.reference import kimi_k2 as ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.moe_decode import moe_decode_ffn  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SEQ = 96
HELD, ROUTED = 4, 12
PUBLISHED = ROOT / "portbench" / "configs" / "kimi-k2-instruct.json"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(held=HELD, offset=0, shared=True, cf=1.25):
    """(the port's ``ArchConfig``, the reference's configuration dict) of
    Kimi-K2 at the small size, holding experts ``offset`` .. + ``held``
    - 1 of ``ROUTED``."""
    a = get_config("kimi-k2-instruct")
    m = a.model
    model = dataclasses.replace(
        m, num_layers=3, d_model=64, d_ff=40, vocab_size=128,
        attention=dataclasses.replace(
            m.attention, n_heads=4, n_kv_heads=4, d_head=24,
            qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=24,
            kv_lora_rank=16),
        moe=dataclasses.replace(
            m.moe, num_experts=held, router_experts=ROUTED,
            expert_offset=offset, top_k=3, d_ff_expert=24, d_ff_routed=24,
            d_ff_shared=24 if shared else None, capacity_factor=cf),
        max_position_embeddings=4096)
    acfg = a.replace(model=model, train=dataclasses.replace(
        a.train, param_dtype="float32", compute_dtype="float32"))
    pub = json.loads(PUBLISHED.read_text())
    cfg = dict(pub, hidden_size=64, intermediate_size=40, vocab_size=128,
               num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, head_dim=24, qk_nope_head_dim=16,
               qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=24,
               kv_lora_rank=16, moe_intermediate_size=24,
               n_routed_experts=ROUTED, num_local_experts=held,
               num_experts_per_tok=3, capacity_factor=cf,
               torch_dtype="float32")
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
    return np.array(toks), torch.stack(logits), states


def test_the_config_is_as_published():
    m = get_config("kimi-k2-instruct").model
    pub = json.loads(PUBLISHED.read_text())
    att, moe = m.attention, m.moe
    assert (m.num_layers, m.d_model, m.vocab_size, m.d_ff, m.first_k_dense,
            m.norm_eps, m.tie_embeddings) == (
        pub["num_hidden_layers"], pub["hidden_size"], pub["vocab_size"],
        pub["intermediate_size"], pub["first_k_dense_replace"],
        pub["rms_norm_eps"], pub["tie_word_embeddings"])
    assert (att.n_heads, att.q_lora_rank, att.kv_lora_rank,
            att.d_head - att.qk_rope_head_dim, att.qk_rope_head_dim,
            att.v_head_dim, att.rope_theta) == (
        pub["num_attention_heads"], pub["q_lora_rank"],
        pub["kv_lora_rank"], pub["qk_nope_head_dim"],
        pub["qk_rope_head_dim"], pub["v_head_dim"], pub["rope_theta"])
    rs, y = pub["rope_scaling"], att.yarn
    assert (y.factor, y.original_max_position_embeddings, y.beta_fast,
            y.beta_slow, y.mscale, y.mscale_all_dim) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"],
        rs["mscale_all_dim"])
    assert att.rope_interleaved
    assert (moe.n_routed, moe.top_k, moe.expert_d_ff, moe.d_ff_shared,
            moe.scoring, moe.routed_scaling_factor) == (
        pub["n_routed_experts"], pub["num_experts_per_tok"],
        pub["moe_intermediate_size"],
        pub["n_shared_experts"] * pub["moe_intermediate_size"],
        pub["scoring_func"], pub["routed_scaling_factor"])
    assert pub["norm_topk_prob"]      # the port always normalises
    assert (pub["topk_method"], pub["n_group"], pub["topk_group"]) == (
        "noaux_tc", 1, 1)
    assert pub["reduced"] == {"num_local_experts": 384}
    assert pub["num_local_experts"] == 8


def test_parameter_counts_are_the_published_layers():
    """``param_counts`` counts MLA by its ranks, the dense layer 0, the
    router and its bias over 384, the shared expert and the experts held
    at 2048 wide, whatever ``d_ff_expert`` the harness sets: the card's
    share (8 held) is ``yardstick/mla.py``'s 32.86 B, and the whole model
    (384 held) about 1.03 T with 32.9 B active a token."""
    from portbench.yardstick import mla
    pub = json.loads(PUBLISHED.read_text())
    whole = get_config("kimi-k2-instruct").model
    # as the harness builds the share: num_experts and d_ff_expert from
    # num_local_experts and intermediate_size
    share = dataclasses.replace(whole, moe=dataclasses.replace(
        whole.moe, num_experts=pub["num_local_experts"],
        d_ff_expert=pub["intermediate_size"]))
    d, v = pub["hidden_size"], pub["vocab_size"]
    dense, moe = 1, 60

    def hand(held):
        return (2 * v * d + d
                + dense * (mla.mla_params(pub) + mla.dense_params(pub)
                           + 2 * d)
                + moe * (mla.mla_params(pub) + held * mla.expert_params(pub)
                         + mla.router_params(pub) + mla.shared_params(pub)
                         + 2 * d))
    assert share.num_params() == hand(8)
    assert round(share.num_params() / 1e9, 2) == 32.86
    assert whole.num_params() == hand(384)
    assert round(whole.num_params() / 1e12, 2) == 1.03
    # a token reaches 8 of 384 experts: 8 x 8 / 384 of the share's 8
    e = mla.expert_params(pub)
    assert whole.num_active_params() == hand(8)
    assert round(whole.num_active_params() / 1e9, 1) == 32.9
    assert share.num_active_params() == int(hand(8) - moe * e * 8 * (
        1 - 8 / 384))


def test_yarn_frequencies_and_scale_are_the_published_formulas():
    """At the published numbers the correction dims are c = 64 ln(4096 /
    2 pi) / (2 ln 50000) = 19.16 for both betas, so the ramp runs from
    19 to 20: dims 0-19 keep theta^(-2i/64) and 20-31 divide it by 32.
    The scores' scale is 192^-0.5 (0.1 ln 32 + 1)^2; cos and sin keep
    scale 1 (mscale / mscale_all_dim)."""
    att = get_config("kimi-k2-instruct").model.attention
    c = 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000))
    assert 19 < c < 20
    assert layers.yarn_correction_range(64, 50000.0, att.yarn) == (19, 20)
    got = layers.rope_frequencies(64, 50000.0, "cpu", att.yarn).double()
    base = 50000.0 ** -(torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    want = torch.where(torch.arange(32) <= 19, base, base / 32)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    m = 0.1 * math.log(32) + 1
    assert attn.softmax_scale(att) == pytest.approx(192 ** -0.5 * m * m,
                                                    rel=1e-12)
    # an interleaved rotation: the pair (x0, x1) at frequency 0, angle t
    x = torch.zeros(1, 1, 4)
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.tensor([3]), 50000.0, interleaved=True)
    torch.testing.assert_close(out[0, 0], torch.tensor(
        [math.cos(3), math.sin(3), 0.0, 0.0]))


def test_the_sigmoid_router_against_a_hand_computation():
    """Logits chosen by hand over 5 experts, top-2: experts 1 and 3 tie
    on their sigmoid, and the bias breaks the tie for 3; expert 0 has
    the largest score but a bias that drops it. The weights are the
    unbiased sigmoids of the chosen, normalised, times 2.827."""
    moe = dataclasses.replace(get_config("kimi-k2-instruct").model.moe,
                              router_experts=5, top_k=2)
    logits = torch.tensor([[3.0, 1.0, 2.0, 1.0, -1.0]])
    p = {"router": torch.eye(5), "router_bias":
         torch.tensor([-2.0, 0.0, 0.5, 0.25, 0.0])}
    gates, top_w, top_i = moe_lib.route(moe, p, logits)
    s = 1 / (1 + torch.exp(-logits[0]))
    # s + b: 0.953 - 2, 0.731, 0.881 + 0.5, 0.731 + 0.25, 0.269
    assert top_i.tolist() == [[2, 3]]
    want = torch.stack([s[2], s[3]]) / (s[2] + s[3]) * 2.827
    torch.testing.assert_close(top_w[0], want)
    torch.testing.assert_close(gates[0], s)
    p["router_bias"] = torch.tensor([-2.0, 0.25, 0.5, 0.0, 0.0])
    assert moe_lib.route(moe, p, logits)[2].tolist() == [[2, 1]]


@pytest.mark.parametrize("plen", [40, 70])
def test_prefill_logits_match_the_reference(plen):
    acfg, cfg = small()
    params = W.draw_params(cfg, 3, "cpu")
    prompt = _prompt(plen, plen)
    _, logits, _ = _served(acfg, params, prompt, 1)
    want = ref.served_logits(cfg, 3, [(prompt, np.zeros(1, np.int64))],
                             "cpu")[0]
    torch.testing.assert_close(logits, want, **TOL)


def test_decode_through_the_latent_cache_matches_the_full_forward():
    """Prefill, then 6 absorbed decode steps through the latent cache,
    against the reference's expanded forward over prompt and served
    tokens whole. The cache holds c_kv and k_pe alone: kv_lora_rank +
    qk_rope_head_dim values a position a layer (576 at the published
    widths)."""
    acfg, cfg = small()
    params = W.draw_params(cfg, 4, "cpu")
    prompt = _prompt(61, 7)
    toks, logits, states = _served(acfg, params, prompt, 7)
    want = ref.served_logits(cfg, 4, [(prompt, toks)], "cpu")[0]
    torch.testing.assert_close(logits, want, **TOL)
    for st in states:
        cache = st["mixer"]
        assert isinstance(cache, attn.MLACache)
        assert cache.c_kv.shape == (1, MAX_SEQ, 16)
        assert cache.k_pe.shape == (1, MAX_SEQ, 8)
        assert int(cache.index) == 61 + 6
    full = get_config("kimi-k2-instruct").model.attention
    c = attn.init_mla_cache(full, 1, 4, torch.bfloat16, device="meta")
    assert c.c_kv.shape[-1] + c.k_pe.shape[-1] == 576


@pytest.mark.parametrize("mechanism", ["bias", "scaling", "mscale", "ramp",
                                       "dense", "held"])
def test_each_mechanism_moves_the_logits(mechanism):
    """The reference with one mechanism changed (the bias left out of the
    choice, no scaling, no mscale on the scores, the ramp at another
    beta, layer 0 an MoE, one held expert fewer) lies well past the
    tolerance from the port's logits, which match the published one."""
    acfg, cfg = small()
    params = W.draw_params(cfg, 5, "cpu")
    prompt = _prompt(40, 11)
    toks, logits, _ = _served(acfg, params, prompt, 3)
    rs = cfg["rope_scaling"]
    other = {"bias": dict(cfg),
             "scaling": dict(cfg, routed_scaling_factor=1.0),
             "mscale": dict(cfg, rope_scaling=dict(rs, mscale_all_dim=0.0)),
             "ramp": dict(cfg, rope_scaling=dict(rs, beta_fast=32.0)),
             "dense": dict(cfg, first_k_dense_replace=0),
             "held": dict(cfg)}[mechanism]
    if mechanism == "bias":
        orig = ref.route

        def unbiased(c, p, x):
            return orig(c, dict(p, router_bias=p["router_bias"] * 0), x)
        ref.route = unbiased
    if mechanism == "held":
        orig_moe = ref.moe

        def all_held(c, p, x, n, control, held=None, shared=True):
            return orig_moe(c, p, x, n, control, held=range(HELD - 1),
                            shared=shared)
        ref.moe = all_held
    try:
        # "dense": layer 0 an MoE, its weights drawn as one
        off = ref.served_logits(other, 5, [(prompt, toks)], "cpu")[0]
    finally:
        if mechanism == "bias":
            ref.route = orig
        if mechanism == "held":
            ref.moe = orig_moe
    torch.testing.assert_close(logits, ref.served_logits(
        cfg, 5, [(prompt, toks)], "cpu")[0], **TOL)
    assert (off - logits).abs().max() > 1e-2


@pytest.mark.parametrize("dropless", [False, True])
def test_the_held_shares_add_up_to_the_uncut_layer(dropless):
    """The expert share against the whole layer: 6 shares of 2 experts each
    out of 12, every share routing over all 12 and computing its own
    experts' part (the prefill under the whole router's capacity, which
    drops here; the decode dropless through the routed path); their sum,
    with the shared expert counted once, is the uncut reference's
    layer."""
    _, cfg = small(held=ROUTED)
    T = 1 if dropless else 70
    p = ref.W.draw_layer(cfg, 8, 1, "cpu")["ffn"]
    x = torch.randn(T, 64, generator=torch.Generator().manual_seed(2))
    want = ref.moe(cfg, p, x, 0 if dropless else T, None)
    total = ref.swiglu(x, p["shared_gate"], p["shared_up"],
                       p["shared_down"], None)
    if not dropless:
        assert moe_lib._capacity(small()[0].model.moe, T, False) < T
    for s in range(6):
        acfg, _ = small(held=2, offset=2 * s, shared=False)
        ps = dict(p, **{k: p[k][2 * s:2 * s + 2]
                        for k in ("w_gate", "w_up", "w_down")})
        with torch.no_grad():
            y, _ = moe_lib._moe_local(acfg.model, acfg.model.moe, ps, x,
                                      dropless=dropless)
        total = total + y
    torch.testing.assert_close(total, want, **TOL)


def test_held_drops_and_the_mla_range_are_counted_while_profiling():
    """``DROPS`` counts the prompt's assignments of the two MoE layers
    only while a profiler records (the decode is dropless and not
    counted): every assignment, those routed to held experts and those
    of them dropped; every eager MLA call opens ``model.mla``."""
    from torch.profiler import ProfilerActivity, profile
    acfg, cfg = small(cf=0.5)
    params = W.draw_params(cfg, 6, "cpu")
    prompt = _prompt(90, 3)
    moe_lib.DROPS.reset()
    _served(acfg, params, prompt, 2)
    assert moe_lib.DROPS.read() == (0, 0)
    assert moe_lib.DROPS.assigned == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _served(acfg, params, prompt, 2)
    dropped, routed = moe_lib.DROPS.read()
    assigned = moe_lib.DROPS.assigned
    moe_lib.DROPS.reset()
    C = moe_lib._capacity(acfg.model.moe, 90, False)
    assert C == 12
    # two MoE layers route 90 tokens to 3 of 12 experts each
    assert assigned == 2 * 90 * 3
    assert 0 < routed - dropped <= 2 * HELD * C and dropped > 0
    assert routed < assigned
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("model.mla") == 3 * 2


def test_k5_plain_gives_zero_rows_for_experts_not_held():
    """Weights of experts 4-6: rows routed to 0 and 9 are zero, the others
    their expert's GLU FFN."""
    gen = torch.Generator().manual_seed(0)
    w = [torch.randn(s, generator=gen) for s in
         ((3, 16, 24), (3, 16, 24), (3, 24, 16))]
    x = torch.randn(5, 16, generator=gen)
    ids = torch.tensor([4, 0, 6, 5, 9])
    out = moe_decode_ffn(x, ids, *w, "silu", expert_offset=4)
    assert torch.equal(out[[1, 4]], torch.zeros(2, 16))
    for row, e in ((0, 0), (2, 2), (3, 1)):
        h = torch.nn.functional.silu(x[row] @ w[0][e]) * (x[row] @ w[1][e])
        torch.testing.assert_close(out[row], h @ w[2][e], **TOL)
