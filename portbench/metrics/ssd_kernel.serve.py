"""Mamba-2 mixer: the share of the ``serve.prefill`` ranges inside the
traced sub-window in which a K6 kernel starts (the chunked SSD scan of
``csrc/ssd_scan.cu``, whose kernels are named ``ssd_scan*``), in %.
Read from the device trace by kernel name, as ``moe_routed.serve`` reads
the decodes: 0 where prefills ran without K6 (the plain loop over
chunks); nothing where there is no trace or no prefill range, or the
program has no K6 (no ``kernels.ssd_scan``).

It reads ``serve.prefill`` and not ``model.mamba``: a prefill ends in
its token's copy to the host, so every kernel it launched starts inside
its range, while a kernel may start after its ``model.mamba`` host range
has closed once the host runs ahead of the device. A prefill the
sub-window's bounds cut is left out, as its kernels may lie outside."""
import importlib.util
from bisect import bisect_left

from portbench import regions


def read(rec):
    tr = regions.traced(rec)
    if tr is None:
        return None
    lo, hi = tr.bounds
    prefills = sorted((a, b) for n, a, b in tr.host
                      if n == "serve.prefill" and lo <= a and b <= hi)
    starts = sorted(a for _, a, _ in tr.named("ssd_scan"))
    if not prefills or importlib.util.find_spec(
            "repro_torch.kernels.ssd_scan") is None:
        return None
    held = sum(bisect_left(starts, b) > bisect_left(starts, a)
               for a, b in prefills)
    return 100.0 * held / len(prefills)
