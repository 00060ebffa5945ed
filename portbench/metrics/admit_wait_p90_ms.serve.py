"""Scheduler: the 90th percentile (nearest rank) of the ``waiting``
spans the endpoint's scheduler records on the traced fabric, from a
request's arrival at the server to its admission, in milliseconds."""
import math


def read(rec):
    waits = sorted(s.duration_s for s in rec.get("spans", [])
                   if s.category == "server" and s.name == "waiting")
    if not waits:
        return None
    return 1e3 * waits[max(0, math.ceil(0.9 * len(waits)) - 1)]
