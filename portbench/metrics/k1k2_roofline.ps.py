"""K1 / K2 (payload pack / unpack): the bytes of one pack and one
unpack a round (``yardstick.bounds.pack_bytes``: read once, written
once) over HBM bandwidth, for the rounds inside the device trace, over
K1 and K2's device time, in %."""
from portbench.yardstick.bounds import pack_bytes
from portbench.yardstick.peaks import HBM_BPS


def read(rec):
    tr, n = rec.get("trace"), rec.get("trace_rounds", 0)
    if tr is None or not n:
        return None
    kk = tr.named("pp_kernel")
    if len(kk) != 2 * n:
        return None
    t = sum(b - a for _, a, b in kk)
    return 100.0 * 2 * n * pack_bytes(rec["rows"], rec["sizes"]) \
        / HBM_BPS / t
