"""Fixtures of the benchmark's CPU tests: the port and this folder on
``sys.path``, torch on one thread, and a data folder of tiny cells
(configurations, mixes and cells as data files only, beside a
``BENCHMARK.json`` that names them) that the harness runs on the CPU.

  PYTHONPATH=src python -m pytest -q portbench/tests
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MOE = {"arch": "mixtral-8x7b", "family": "moe", "hidden_size": 64,
            "intermediate_size": 96, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16,
            "num_hidden_layers": 2, "num_local_experts": 4,
            "num_experts_per_tok": 2, "vocab_size": 128,
            "rope_theta": 1e6, "sliding_window": 64, "rms_norm_eps": 1e-6,
            "hidden_act": "silu", "tie_word_embeddings": False,
            "torch_dtype": "float32", "capacity_factor": 1.25}
TINY_RWKV = {"arch": "rwkv6-1.6b", "family": "rwkv6", "hidden_size": 64,
             "intermediate_size": 96, "head_size": 16,
             "num_hidden_layers": 2, "vocab_size": 128,
             "layer_norm_epsilon": 1e-6, "decay_lora_rank": 8,
             "tie_word_embeddings": False, "torch_dtype": "float32"}
TINY_MOE_TRAIN = dict(
    TINY_MOE, router_aux_loss_coef=0.01,
    train={"optimizer": "adamw", "learning_rate": 3e-4,
           "warmup_steps": 100, "total_steps": 10000,
           "weight_decay": 0.1, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
           "grad_clip": 1.0, "remat": True,
           "remat_policy": "nothing_saveable", "master_dtype": "float32"})
#: closed loop (as the benchmark's serve cells run), and open loop at a
#: rate (as ``sweep.py`` runs)
SERVE_CELLS = ("tiny-moe.serve", "tiny-rwkv.serve", "tiny-moe.open")
#: the tiny training cell's limits: float32 on both sides here
TINY_TRAIN_LIMITS = {"loss_rel_gap": 1e-5, "grad_norm_gap": 1e-4,
                     "change_norm_gap": 1e-4, "grad_median_gap": 1e-4,
                     "change_median_gap": 1e-4}
#: the tiny cells' limit on the widest logit gap: the program runs in
#: float32 on the CPU here, as the reference does
TINY_GAP_LIMIT = 1e-3


def _mix(name: str, **kw) -> dict:
    mix = json.loads((ROOT / "portbench" / "mixes" / f"{name}.json")
                     .read_text())
    mix.update(kw)
    return mix


def write_tiny(d: Path) -> Path:
    for sub in ("configs", "mixes", "cells"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    (d / "configs" / "tiny-moe.json").write_text(json.dumps(TINY_MOE))
    (d / "configs" / "tiny-rwkv.json").write_text(json.dumps(TINY_RWKV))
    (d / "configs" / "tiny-moe-train.json").write_text(
        json.dumps(TINY_MOE_TRAIN))
    (d / "mixes" / "tiny-train.json").write_text(json.dumps(_mix(
        "train-4k", seq_len=64, batch=2)))
    (d / "cells" / "tiny-train.json").write_text(json.dumps(
        {"limits": TINY_TRAIN_LIMITS}))
    tiny_serve = _mix(
        "azure-code",
        prompt_tokens={"dist": "lognormal", "median": 40, "sigma": 0.8,
                       "lo": 8, "hi": 100},
        answer_tokens={"dist": "lognormal", "median": 5, "sigma": 0.9,
                       "lo": 2, "hi": 12},
        arrivals={"process": "closed", "clients": 4, "pool": 8,
                  "cycles": 400},
        check_tokens=40, drain_cap_s=30)
    (d / "mixes" / "tiny-serve.json").write_text(json.dumps(tiny_serve))
    (d / "mixes" / "tiny-open.json").write_text(json.dumps(
        dict(tiny_serve, arrivals={"process": "poisson"})))
    (d / "mixes" / "tiny-ps.json").write_text(json.dumps(_mix(
        "ps-serialized", buffer_bytes=[1000, 64, 4096, 2, 130],
        checked_among_first=20)))
    for c in SERVE_CELLS:
        cell = {"limits": {"max_logit_gap": TINY_GAP_LIMIT}}
        if c.endswith(".open"):
            cell["rate_rps"] = 4.0
        (d / "cells" / f"{c}.json").write_text(json.dumps(cell))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    serve, ps, train = list(SERVE_CELLS), ["tiny-ps"], ["tiny-train"]
    bench["workloads"] = [
        {"name": "tiny-moe.serve", "config": "tiny-moe",
         "traffic": "tiny-serve", "chips": 1, "why": "test"},
        {"name": "tiny-rwkv.serve", "config": "tiny-rwkv",
         "traffic": "tiny-serve", "chips": 1, "why": "test"},
        {"name": "tiny-moe.open", "config": "tiny-moe",
         "traffic": "tiny-open", "chips": 1, "why": "test"},
        {"name": "tiny-ps", "config": "tiny-moe", "traffic": "tiny-ps",
         "chips": 1, "why": "test"},
        {"name": "tiny-train", "config": "tiny-moe-train",
         "traffic": "tiny-train", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = m["workloads"][0].split(".")[-1]
            m["workloads"] = {"ps-serialized": ps,
                              "train-4k": train}.get(kind, serve)
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


@pytest.fixture(scope="session")
def tiny_dir(tmp_path_factory) -> Path:
    return write_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_tiny(tiny_dir: Path, cell: str, seed: int = 5,
             seconds: float = 2.0, trace: bool = False):
    from portbench import harness
    h = harness.Harness(cell, seed, seconds, trace, device="cpu",
                        data_dir=tiny_dir)
    return harness.run_cell(h)
