"""Model (Kimi-K2), decode: the bytes a batch-1 decode step must move
(``yardstick.mla.decode_bytes``: MLA, the dense layer, the routers,
the shared experts, the held experts a token is routed to on average,
the head, and the latent cache at the window's mean prompt length) at
HBM bandwidth, over the device time inside each ``serve.decode`` range
(as ``decode_busy_ms.serve`` counts it), for the ranges of the traced
sub-window, in %."""
from portbench import regions
from portbench.yardstick.mla import decode_bytes
from portbench.yardstick.peaks import HBM_BPS


def read(rec):
    cfg = rec.get("config") or {}
    tr = regions.traced(rec)
    lens = rec.get("prefill_lens", [])
    if tr is None or cfg.get("family") != "kimi_k2" or not lens:
        return None
    decodes = regions.ranges(tr, "serve.decode")
    if not decodes:
        return None
    busy = sum(regions.covered(decodes, regions.busy(tr)))
    ctx = sum(lens) / len(lens)
    return 100.0 * len(decodes) * decode_bytes(cfg, ctx) / (busy * HBM_BPS)
