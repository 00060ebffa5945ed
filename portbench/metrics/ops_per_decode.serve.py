"""Engine: device operations (kernels, copies, sets) that start inside
``serve.decode`` ranges, per range, in the traced sub-window."""
from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    decodes = regions.ranges(tr, "serve.decode")
    if not decodes:
        return None
    return regions.starts_inside(tr, decodes) / len(decodes)
