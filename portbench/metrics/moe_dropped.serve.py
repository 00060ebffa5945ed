"""MoE dispatch: the prompts' assignments routed past their expert's
capacity over every assignment the prefills routed, in %, counted on the
device by the program (``repro_torch.models.moe.DROPS``) only while the
profiler recorded, so over the traced sub-window's prefills, and read
once, here, after the window. Nothing from a run without a trace or a
program without the count."""
from portbench import regions


def read(rec):
    if regions.traced(rec) is None:
        return None
    try:
        from repro_torch.models.moe import DROPS
    except ImportError:
        return None
    dropped, routed = DROPS.read()
    if not routed:
        return None
    return 100.0 * dropped / routed
