"""Mamba-2 mixer: the device time inside the ``model.mamba`` ranges that
lie in ``serve.prefill`` ranges over the device time inside those
``serve.prefill`` ranges, in the traced sub-window, in %. A range's
device time is the union of the device's busy intervals inside it on
the trace's clock, as ``decode_busy_ms.serve`` counts it: the SSD's
chunk loop launches small kernels one after another, so its device work
runs as it is launched. Nothing where the program opens no
``model.mamba`` range."""
from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    prefills = regions.union(regions.ranges(tr, "serve.prefill"))
    mamba = regions.union(regions.nested(regions.ranges(tr, "model.mamba"),
                                         prefills))
    if not prefills or not mamba:
        return None
    busy = regions.busy(tr)
    return 100.0 * sum(regions.covered(mamba, busy)) \
        / sum(regions.covered(prefills, busy))
