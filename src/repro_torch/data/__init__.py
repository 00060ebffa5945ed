"""The synthetic, step-indexed data pipeline (``pipeline``)."""
