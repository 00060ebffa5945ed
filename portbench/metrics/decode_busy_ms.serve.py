"""Engine: milliseconds of device work inside each ``serve.decode``
range (the union of the device's intervals there; the op ends in its
token's copy to the host, so its work is inside it), averaged over the
ranges of the traced sub-window."""
from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    decodes = regions.ranges(tr, "serve.decode")
    if not decodes:
        return None
    return 1e3 * sum(regions.covered(decodes, regions.busy(tr))) \
        / len(decodes)
