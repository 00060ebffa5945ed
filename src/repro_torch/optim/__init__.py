"""Optimizers (``optimizer``): AdamW, Adafactor, SGD, global-norm
clipping, the warmup+cosine schedule and gradient compression with
error feedback, as plain functions on tensor trees."""
