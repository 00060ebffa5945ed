"""Frozen arithmetic of the benchmark: peaks, traffic generators, bounds
and model FLOPs. Later changes to the port cannot move these."""
