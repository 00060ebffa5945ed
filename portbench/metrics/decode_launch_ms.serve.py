"""Engine: mean milliseconds of the ``serve.launch`` ranges nested in
``serve.decode`` ranges (the host enqueueing one decode's forward and
sampling), inside the traced sub-window."""
from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    launches = regions.nested(regions.ranges(tr, "serve.launch"),
                              regions.ranges(tr, "serve.decode"))
    if not launches:
        return None
    return 1e3 * sum(b - a for a, b in launches) / len(launches)
