"""Optimizer: mean milliseconds of the step's AdamW half
(``optimizer.apply_updates``) between two CUDA events, over the steps
inside the device trace."""


def read(rec):
    s = rec.get("optimizer_s", [])
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
