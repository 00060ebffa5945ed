"""Engine: mean host milliseconds of one decode op
(``ServeEngine.op_seconds["decode"]``, each ending in the device-to-host
copy of its token) over the window."""


def read(rec):
    ops = rec.get("op_seconds", {}).get("decode", [])
    if not ops:
        return None
    return 1e3 * sum(ops) / len(ops)
