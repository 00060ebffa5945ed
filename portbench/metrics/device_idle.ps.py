"""Device: 1 - (union of the device operations' intervals) / (the
traced sub-window's wall time), in %."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
