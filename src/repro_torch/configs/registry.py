"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, reduced

_ARCH_MODULES = {
    "hubert-xlarge":        "repro_torch.configs.hubert_xlarge",
    "mixtral-8x7b":         "repro_torch.configs.mixtral_8x7b",
    "kimi-k2-1t-a32b":      "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen1.5-4b":           "repro_torch.configs.qwen15_4b",
    "nemotron-4-15b":       "repro_torch.configs.nemotron_4_15b",
    "qwen3-8b":             "repro_torch.configs.qwen3_8b",
    "gemma2-9b":            "repro_torch.configs.gemma2_9b",
    "internvl2-76b":        "repro_torch.configs.internvl2_76b",
    "rwkv6-1.6b":           "repro_torch.configs.rwkv6_1b6",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1p5_large",
}

#: port-only architectures: reachable through ``get_config``, outside
#: ``list_archs`` (and so outside the dry run's cells), which the
#: reference's registry lists too
_PORT_ONLY_MODULES = {
    "granite-4.0-h-small":  "repro_torch.configs.granite_4p0_h_small",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ArchConfig:
    modules = {**_ARCH_MODULES, **_PORT_ONLY_MODULES}
    if arch not in modules:
        raise KeyError(f"unknown arch {arch!r}; known: {list(modules)}")
    mod = importlib.import_module(modules[arch])
    cfg: ArchConfig = mod.CONFIG
    assert cfg.model.name == arch, (cfg.model.name, arch)
    return cfg


def get_reduced_config(arch: str, **kw) -> ArchConfig:
    return reduced(get_config(arch), **kw)


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; 40 assigned, minus documented skips."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        skips: Dict[str, str] = dict(cfg.skip_reasons)
        for shape in SHAPES:
            if shape in cfg.shapes:
                out.append((arch, shape, None))
            elif include_skipped:
                out.append((arch, shape, skips.get(shape, "unsupported")))
    return out
