"""MoE dispatch: the share of the ``serve.decode`` ranges in the traced
sub-window that hold K5's launches (the routed-expert GLU FFN of
``csrc/moe_decode.cu``, whose kernels are named ``moe_decode_*``), in %.
Read from the device trace by kernel name, as ``ops_per_decode.serve``
counts operations: 0 where decodes ran but no K5 kernel (a decode that
stopped taking the routed path); nothing where there is no trace or no
decode range, or the program has no K5 (no ``kernels.moe_decode``)."""
import importlib.util
from bisect import bisect_left

from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    decodes = regions.ranges(tr, "serve.decode")
    starts = sorted(a for _, a, _ in tr.named("moe_decode"))
    if not decodes or importlib.util.find_spec(
            "repro_torch.kernels.moe_decode") is None:
        return None
    held = sum(bisect_left(starts, b) > bisect_left(starts, a)
               for a, b in decodes)
    return 100.0 * held / len(decodes)
