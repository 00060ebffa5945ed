"""Model (Kimi-K2: MLA beside a share of a sigmoid-routed MoE): the
FLOPs of every prefill in the window (``yardstick.mla.prefill_flops``:
MLA's projections, attention at its true head dims, the dense layer,
the routers, the shared experts, the held experts' kept assignments,
the head at the last position) over the sum of the prefill ops' host
seconds times the bf16 peak, in %: the share of the whole step's peak.
The held experts' assignments are taken at the share of all assignments
that ``repro_torch.models.moe.DROPS`` counted routed to held experts and
kept in the traced prefills. Nothing from a run without a trace, a
configuration of another family or a program without the count."""
from portbench import regions
from portbench.yardstick.mla import prefill_flops
from portbench.yardstick.peaks import BF16_FLOPS


def read(rec):
    cfg = rec.get("config") or {}
    lens = rec.get("prefill_lens", [])
    secs = rec.get("op_seconds", {}).get("prefill", [])
    if cfg.get("family") != "kimi_k2" or regions.traced(rec) is None \
            or not lens or not secs:
        return None
    try:
        from repro_torch.models.moe import DROPS
    except ImportError:
        return None
    assigned = getattr(DROPS, "assigned", 0)
    if not assigned:
        return None
    dropped, routed = DROPS.read()
    share = (routed - dropped) / assigned
    k = cfg["num_experts_per_tok"]
    flops = sum(prefill_flops(cfg, s, held=share * s * k) for s in lens)
    return 100.0 * flops / (sum(secs) * BF16_FLOPS)
