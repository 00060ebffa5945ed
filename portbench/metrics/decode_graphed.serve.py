"""Engine: the share of the ``serve.decode`` ranges in the traced
sub-window that hold a ``serve.graph`` range (a decode step replayed as
one CUDA graph), in %. Nothing where the program opens no ``serve.graph``
range."""
from bisect import bisect_left

from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    graphs = regions.ranges(tr, "serve.graph")
    decodes = regions.ranges(tr, "serve.decode")
    if not graphs or not decodes:
        return None
    starts = [a for a, _ in graphs]
    held = 0
    for a, b in decodes:
        i = bisect_left(starts, a)
        held += any(e <= b for _, e in graphs[i:bisect_left(starts, b)])
    return 100.0 * held / len(decodes)
