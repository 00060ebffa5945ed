"""Engine: time with nothing on the device inside any engine op range
(``serve.prefill``, ``serve.rebuild``, ``serve.decode``), over the
traced sub-window, in %."""
from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    ops = regions.union(regions.ranges(tr, *regions.ENGINE))
    if not ops:
        return None
    return 100.0 * regions.idle(tr, ops) / tr.window_s
