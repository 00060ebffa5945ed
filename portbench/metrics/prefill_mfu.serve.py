"""Model: the model FLOPs of every prefill in the window
(``yardstick.flops.prefill_flops``: products, attention or the WKV
scan, the head at the last position) over the sum of the prefill ops'
host seconds times the bf16 peak, in %."""
from portbench.yardstick.flops import prefill_flops
from portbench.yardstick.peaks import BF16_FLOPS


def read(rec):
    lens = rec.get("prefill_lens", [])
    secs = rec.get("op_seconds", {}).get("prefill", [])
    if not lens or not secs:
        return None
    flops = sum(prefill_flops(rec["config"], s) for s in lens)
    return 100.0 * flops / (sum(secs) * BF16_FLOPS)
