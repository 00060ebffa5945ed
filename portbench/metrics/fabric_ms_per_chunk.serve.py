"""RPC fabric: milliseconds of wire time (``rpc.Tracer`` wire spans:
framing, copy and delivery of every frame of the streamed calls) per
chunk the clients received, over the traced run's window."""


def read(rec):
    wire = [s for s in rec.get("spans", []) if s.category == "wire"]
    if not wire or not rec.get("chunks"):
        return None
    return 1e3 * sum(s.duration_s for s in wire) / rec["chunks"]
