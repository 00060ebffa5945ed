"""RPC fabric and scheduler: time with nothing on the device inside
``rpc.flush`` ranges but outside every engine op range (framing,
delivery, stream pumps, admission), over the traced sub-window, in %.
The rest of ``device_idle.serve`` is the client's loop, outside every
range."""
from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    flushes = regions.union(regions.ranges(tr, "rpc.flush"))
    if not flushes:
        return None
    ops = regions.union(regions.ranges(tr, *regions.ENGINE))
    return 100.0 * regions.idle(tr, regions.minus(flushes, ops)) \
        / tr.window_s
