"""Serving: the engine (``engine``) and its continuous-batching
scheduler (``scheduler``)."""
