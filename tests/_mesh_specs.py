"""The 2 x 2 mesh cases of tests/test_torch_mesh.py, shared by the port's
side (tests/_torch_mesh_cases.py, on spawned gloo ranks) and the
reference's (tests/_jax_mesh_cases.py, on four forced host devices).
Plain Python: each side builds its own package's config from a spec."""
import dataclasses

SEQ, BATCH = 32, 4

#: two AdamW steps of Qwen3, fsdp off and on, and a vocab that shards;
#: of RWKV-6, fsdp off and on
TRAIN = {"qwen3": dict(arch="qwen3-8b"),
         "qwen3_fsdp": dict(arch="qwen3-8b", fsdp=True),
         "qwen3_v4096": dict(arch="qwen3-8b", fsdp=True, vocab=4096),
         "rwkv6": dict(arch="rwkv6-1.6b"),
         "rwkv6_fsdp": dict(arch="rwkv6-1.6b", fsdp=True)}
#: MoE forwards: tp and ep; the last drops tokens (capacity factor 0.5)
MOE = {"mixtral_tp": dict(arch="mixtral-8x7b", es="tp"),
       "mixtral_ep": dict(arch="mixtral-8x7b", es="ep"),
       "kimi_tp": dict(arch="kimi-k2-1t-a32b", es="tp"),
       "kimi_ep": dict(arch="kimi-k2-1t-a32b", es="ep"),
       "mixtral_drop": dict(arch="mixtral-8x7b", es="ep",
                            capacity_factor=0.5)}
#: forwards of the other attention kinds (gemma2 at a seq its window binds)
FWD = {"hubert": dict(arch="hubert-xlarge", fsdp=True),
       "gemma2": dict(arch="gemma2-9b", seq=128)}
#: one Adafactor step of Kimi-K2 with ep and fsdp
KIMI_TRAIN = {"kimi_train": dict(arch="kimi-k2-1t-a32b", es="ep",
                                 fsdp=True)}
#: one Adafactor step of Jamba (one 8-layer period: Mamba, attention and
#: MoE layers) with tp
JAMBA_TRAIN = {"jamba_train": dict(arch="jamba-1.5-large-398b", es="tp")}
#: one Adafactor step each
ADAFACTOR = {**KIMI_TRAIN, **JAMBA_TRAIN}
#: prefill then greedy decode steps, over the mesh and without (the
#: port's alone: tokens must be equal)
GREEDY = ("qwen3", "rwkv6_fsdp", "jamba_train")
ALL = {**TRAIN, **MOE, **FWD, **ADAFACTOR}


def params_key(spec: dict) -> str:
    """The cases that draw the same parameters share them."""
    return f"{spec['arch']}_v{spec.get('vocab', 0)}"


def build(get_reduced_config, spec: dict):
    cfg = get_reduced_config(spec["arch"])
    model = cfg.model
    if "vocab" in spec:
        model = dataclasses.replace(model, vocab_size=spec["vocab"])
    if "capacity_factor" in spec:
        model = dataclasses.replace(model, moe=dataclasses.replace(
            model.moe, capacity_factor=spec["capacity_factor"]))
    par = dataclasses.replace(cfg.parallel, fsdp=spec.get("fsdp", False),
                              expert_sharding=spec.get("es"))
    return cfg.replace(model=model, parallel=par)


def inputs(name: str, cfg):
    """(tokens or None, embeds or None) of a forward case, as numpy."""
    import numpy as np
    rng = np.random.default_rng(1)
    B, S = BATCH, ALL[name].get("seq", SEQ)
    if cfg.model.frontend is not None:
        return None, rng.standard_normal(
            (B, S, cfg.model.d_model)).astype(np.float32)
    return rng.integers(0, cfg.model.vocab_size, (B, S)).astype(
        np.int32), None
