"""Channels: device operations (kernels, copies, sets) per PS round
inside the device trace."""


def read(rec):
    tr, n = rec.get("trace"), rec.get("trace_rounds", 0)
    if tr is None or not n or not tr.device:
        return None
    return len(tr.device) / n
