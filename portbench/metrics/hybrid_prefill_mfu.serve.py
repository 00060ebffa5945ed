"""Model (Granite-4.0-H): the FLOPs of every prefill in the window
(``yardstick.hybrid.prefill_flops``: the projections, the routed top-k
and shared experts, the chunked SSD's products, attention, the head at
the last position) over the sum of the prefill ops' host seconds times
the bf16 peak, in %."""
from portbench.yardstick.hybrid import prefill_flops
from portbench.yardstick.peaks import BF16_FLOPS


def read(rec):
    cfg = rec.get("config") or {}
    lens = rec.get("prefill_lens", [])
    secs = rec.get("op_seconds", {}).get("prefill", [])
    if cfg.get("family") != "granitemoehybrid" or not lens or not secs:
        return None
    flops = sum(prefill_flops(cfg, s) for s in lens)
    return 100.0 * flops / (sum(secs) * BF16_FLOPS)
