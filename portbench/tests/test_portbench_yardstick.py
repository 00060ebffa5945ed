"""The frozen copies give the originals' numbers today."""
import importlib.util
import json
import math

import numpy as np
import pytest

from conftest import ROOT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rate,dur,seed", [(1.6, 51.0, 0), (4.0, 7.5, 99),
                                           (0.3, 120.0, 2311186770)])
def test_poisson_copy(rate, dur, seed):
    from repro_torch.workload.arrivals import poisson_arrivals
    from portbench.yardstick import arrivals
    np.testing.assert_array_equal(
        arrivals.poisson_arrivals(rate, dur, seed=seed),
        poisson_arrivals(rate, dur, seed=seed))


@pytest.mark.parametrize("median,sigma,lo,hi", [(1500, 0.8, 128, 4000),
                                                (13, 0.9, 2, 64)])
def test_lognormal_copy(median, sigma, lo, hi):
    from repro_torch.workload.lengths import lognormal_lengths
    from portbench.yardstick import lengths
    kw = dict(seed=2311186771, mean=math.log(median), sigma=sigma, lo=lo,
              hi=hi)
    np.testing.assert_array_equal(lengths.lognormal_lengths(500, **kw),
                                  lognormal_lengths(500, **kw))


#: RWKV-6 1.6B's published sizes (``RWKV/v6-Finch-1B6-HF``): no cell
#: serves it now, but the copies count its FLOPs as the port does
RWKV6_1B6 = {"arch": "rwkv6-1.6b", "family": "rwkv6",
             "hidden_size": 2048, "attention_hidden_size": 2048,
             "intermediate_size": 7168, "head_size": 64,
             "num_hidden_layers": 24, "vocab_size": 65536,
             "decay_lora_rank": 64, "tie_word_embeddings": False,
             "torch_dtype": "bfloat16"}


@pytest.mark.parametrize("name", ["mixtral-8x7b", "rwkv6-1.6b"])
def test_param_counts_and_model_flops_copies(name):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.roofline import model_flops
    from portbench.yardstick import flops
    cfg = RWKV6_1B6 if name == "rwkv6-1.6b" else json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    m = get_config(cfg["arch"]).model
    m = dataclasses.replace(m, num_layers=cfg["num_hidden_layers"])
    acfg = get_config(cfg["arch"]).replace(model=m)
    assert flops.param_counts(cfg) == m.param_counts()
    assert flops.num_active_params(cfg) == m.num_active_params()
    for kind, b, s in (("train", 2, 4096), ("prefill", 1, 1500),
                       ("decode", 8, 1)):
        assert flops.model_flops(cfg, kind, b, s) == model_flops(
            acfg, ShapeSpec("x", s, b, kind))


def test_matmul_params_of_mixtral_are_the_active_layer_weights():
    """For Mixtral the metrics' count is the copy's active count less the
    embedding, the head and the norms."""
    from portbench.yardstick import flops
    cfg = json.loads((ROOT / "portbench" / "configs" / "mixtral-8x7b.json")
                     .read_text())
    c = flops.param_counts(cfg)
    active = flops.num_active_params(cfg)
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    assert flops.matmul_params(cfg) * L == \
        active - c["embed"] - c["lm_head"] - c["final_norm"] - 2 * d * L


@pytest.mark.parametrize("sq,causal,window", [(512, True, None),
                                              (1500, True, 4096),
                                              (300, True, 64),
                                              (200, False, None)])
def test_attention_bound_copy(sq, causal, window):
    import torch
    from portbench.yardstick import bounds
    cs = _chip_smoke()
    q = torch.empty((1, sq, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, sq, 8, 128), dtype=torch.bfloat16, device="meta")
    assert bounds.valid_pairs(sq, sq, causal, window) == \
        cs.valid_pairs(sq, sq, causal, window)
    ms, _ = cs.attention_bound(q, k, k, causal, window)
    assert bounds.attention_bound(1, sq, sq, 32, 8, 128, causal, window) \
        == pytest.approx(ms * 1e-3, rel=1e-12)


@pytest.mark.parametrize("bh,s", [(32, 1504), (128, 512)])
def test_wkv_bound_copy(bh, s):
    from portbench.yardstick import bounds
    ms = _chip_smoke().wkv_bound(bh, s, 64, 16)[0]
    assert bounds.wkv_bound(bh, s, 64, 16) == pytest.approx(ms * 1e-3,
                                                            rel=1e-12)


def test_pack_bytes_and_the_mix_payload():
    """The frozen payload is what ``from_arch`` derives for Mixtral
    today, and a pack moves each byte of it in and out once."""
    from repro_torch.configs import get_config
    from repro_torch.core.payload import from_arch
    from portbench.yardstick import bounds
    mix = json.loads((ROOT / "portbench" / "mixes" / "ps-serialized.json")
                     .read_text())
    assert list(from_arch(get_config("mixtral-8x7b")).sizes) == \
        mix["buffer_bytes"]
    assert sum(mix["buffer_bytes"]) == 69_257_216
    assert bounds.pack_bytes(8, mix["buffer_bytes"]) == 2 * 8 * 69_257_216


def test_schedule_copy():
    from repro_torch.core.channels import bipartite_schedule
    from portbench.reference import ps
    for m, n in ((2, 3), (3, 2), (1, 4), (4, 4)):
        a, b = list(range(m)), list(range(m, m + n))
        assert ps.bipartite_schedule(a, b) == bipartite_schedule(a, b)
        assert ps.bipartite_schedule(b, a) == bipartite_schedule(b, a)


def test_peaks_are_the_data_sheets():
    from repro_torch.launch import roofline
    from portbench.yardstick import peaks
    assert peaks.BF16_FLOPS == roofline.PEAK_FLOPS == 989e12
    assert peaks.HBM_BPS == 3.35e12
