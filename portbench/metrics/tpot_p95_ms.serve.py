"""Serving client: the gap between consecutive streamed chunks at the
client at the 95th percentile (nearest rank) over every gap of the
traced run's window, in milliseconds (not a per-request mean). Above the
knee it swings with the queue: recorded, not bounded."""


def read(rec):
    v = rec.get("tails", {}).get("tpot_p95_ms")
    return v if v is not None and v != float("inf") else None
