"""Atomic checkpoints (``checkpoint``) in the reference's on-disk layout,
so either package restores what the other saved."""
