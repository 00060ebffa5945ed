"""Model (Granite-4.0-H), decode: the bytes a batch-1 decode step must
move if it reads only its routed experts
(``yardstick.hybrid.decode_bytes``: every mixer, the router, the top-k
and shared experts, the tied head, the Mamba states read and written)
at HBM bandwidth, over the device time inside each ``serve.decode``
range (as ``decode_busy_ms.serve`` counts it), for the ranges of the
traced sub-window, in %."""
from portbench import regions
from portbench.yardstick.hybrid import decode_bytes
from portbench.yardstick.peaks import HBM_BPS


def read(rec):
    cfg = rec.get("config") or {}
    tr = regions.traced(rec)
    if tr is None or cfg.get("family") != "granitemoehybrid":
        return None
    decodes = regions.ranges(tr, "serve.decode")
    if not decodes:
        return None
    busy = sum(regions.covered(decodes, regions.busy(tr)))
    return 100.0 * len(decodes) * decode_bytes(cfg) / (busy * HBM_BPS)
