"""Serving client: time to first token at the 90th percentile (nearest
rank) over the requests of the traced run's window that started, from
when each was due to the client's first chunk, in milliseconds. Above
the knee the queue grows all through the window, so this tail swings
with the smallest change: recorded, not bounded."""


def read(rec):
    v = rec.get("tails", {}).get("ttft_p90_ms")
    return v if v is not None and v != float("inf") else None
