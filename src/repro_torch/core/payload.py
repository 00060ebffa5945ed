"""Payload generation — the paper's workload model (§2.3, §3.2).

A gRPC payload is a list of iovec buffers drawn from three size
categories (Table 1): Small (bytes), Medium (KB), Large (MB). The suite
generates payloads under three schemes observed in TensorFlow training
traffic (Figure 4):

  uniform — categories cycle evenly through the buffer list
  random  — categories drawn at random per buffer
  skew    — biased mix, default 60% Large / 30% Medium / 10% Small

``from_arch`` additionally derives a payload from a real architecture's
parameter-shape histogram (our framework tie-in: the PS traffic of e.g.
kimi-k2 is dominated by expert matrices => Medium/Large-heavy).

Buffers are padded to TPU lane granularity (128 elements) when
``tpu_align`` is set — the real iovec byte count is preserved separately
for reporting.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import tfgrpc_bench as T
from repro_torch.configs.base import ArchConfig

CATEGORIES = ("small", "medium", "large")


@dataclass(frozen=True)
class PayloadSpec:
    """Sizes (in bytes) of each iovec buffer in one gRPC payload."""
    sizes: Tuple[int, ...]
    scheme: str
    categories: Tuple[str, ...]

    @property
    def total_bytes(self) -> int:
        return int(sum(self.sizes))

    @property
    def n_buffers(self) -> int:
        return len(self.sizes)

    def category_of(self, i: int) -> str:
        return self.categories[i]


def _cat_size(cat: str, cfg: T.BenchConfig) -> int:
    return {"small": cfg.small_bytes, "medium": cfg.medium_bytes,
            "large": cfg.large_bytes}[cat]


def _check_ranges(cfg: T.BenchConfig) -> None:
    lo, hi = T.SMALL_RANGE
    assert lo <= cfg.small_bytes < hi, cfg.small_bytes
    lo, hi = T.MEDIUM_RANGE
    assert lo <= cfg.medium_bytes < hi, cfg.medium_bytes
    lo, hi = T.LARGE_RANGE
    assert lo <= cfg.large_bytes <= hi, cfg.large_bytes


def generate_spec(cfg: T.BenchConfig) -> PayloadSpec:
    """Build the buffer-size list for one payload under cfg.scheme, or
    return the explicit override (cfg.payload_spec, e.g. --arch)."""
    if cfg.payload_spec is not None:
        assert isinstance(cfg.payload_spec, PayloadSpec), cfg.payload_spec
        return cfg.payload_spec
    _check_ranges(cfg)
    cats = tuple(c for c in CATEGORIES if c in cfg.categories)
    assert cats, "need at least one buffer category"
    n = cfg.iovec_count
    rng = np.random.default_rng(cfg.seed)

    if cfg.scheme == "uniform":
        chosen = [cats[i % len(cats)] for i in range(n)]
    elif cfg.scheme == "random":
        assert len(cats) >= 2, "random scheme needs >=2 categories"
        chosen = list(rng.choice(cats, size=n))
    elif cfg.scheme == "skew":
        assert len(cats) >= 2, "skew scheme needs >=2 categories"
        fr = dict(T.SKEW_BIAS_FRACTIONS[cfg.skew_bias])
        # renormalize over the enabled categories
        tot = sum(fr[c] for c in cats)
        counts = {c: int(round(fr[c] / tot * n)) for c in cats}
        # distribute rounding remainder onto the most-biased category
        while sum(counts.values()) < n:
            counts[max(cats, key=lambda c: fr[c])] += 1
        while sum(counts.values()) > n:
            counts[min(cats, key=lambda c: fr[c])] -= 1
        chosen = [c for c in CATEGORIES if c in cats
                  for _ in range(counts[c])]
        rng.shuffle(chosen)
    else:
        raise ValueError(cfg.scheme)

    sizes = tuple(_cat_size(c, cfg) for c in chosen)
    return PayloadSpec(sizes=sizes, scheme=cfg.scheme, categories=tuple(chosen))


def materialize(spec: PayloadSpec, *, dtype=np.uint8, seed: int = 0,
                tpu_align: bool = False) -> List[np.ndarray]:
    """Concrete buffers for a spec. Alignment pads to 128B multiples."""
    rng = np.random.default_rng(seed)
    bufs = []
    for sz in spec.sizes:
        n = sz
        if tpu_align:
            n = max(128, -(-sz // 128) * 128)
        bufs.append(rng.integers(0, 255, size=n, dtype=np.uint8).view(dtype))
    return bufs


def scale_sizes(sizes: Sequence[int], ratio: float) -> List[int]:
    """Scale every iovec size by ``ratio`` (min 1 byte each) — the
    incast push/fetch asymmetry knob. ``ratio=1.0`` is the identity,
    so symmetric paths stay byte-exact."""
    assert ratio > 0, ratio
    return [max(1, int(round(s * ratio))) for s in sizes]


def classify(nbytes: int) -> str:
    if nbytes < T.SMALL_RANGE[1]:
        return "small"
    if nbytes < T.MEDIUM_RANGE[1]:
        return "medium"
    return "large"


def from_arch(acfg: ArchConfig, *, max_buffers: int = 10,
              seed: int = 0) -> PayloadSpec:
    """Payload modeled on an architecture's real parameter tensors: one
    'variable fetch' worth of buffers sampled from the arch's per-tensor
    byte-size histogram (4 bytes/elem, fp32 master copies — what a PS
    actually serves)."""
    counts = acfg.model.param_counts()
    cfg_m = acfg.model
    sizes_pool: List[int] = []
    # embedding rows are fetched in slices; model the slice, not the table
    sizes_pool.append(min(counts["embed"] * 4 // max(cfg_m.vocab_size, 1)
                          * 1024, 8 * 1024 * 1024))
    per_layer = counts["layers"] / max(cfg_m.num_layers, 1)
    # a layer's tensors: a few matrices around d_model*d_ff and d_model^2
    d, f = cfg_m.d_model, cfg_m.d_ff
    sizes_pool += [d * d * 4, d * f * 4, d * 4, 2 * d * 4]
    if cfg_m.moe is not None:
        sizes_pool.append(d * cfg_m.moe.expert_d_ff * 4)   # one expert matrix
        sizes_pool.append(cfg_m.moe.num_experts * d // 64 * 4)  # router slice
    del per_layer
    rng = np.random.default_rng(seed)
    take = [int(sizes_pool[i % len(sizes_pool)])
            for i in range(max_buffers)]
    rng.shuffle(take)
    take = [min(max(s, 1), T.LARGE_RANGE[1]) for s in take]
    return PayloadSpec(sizes=tuple(take), scheme=f"arch:{cfg_m.name}",
                       categories=tuple(classify(s) for s in take))
