"""Least device times of the port's hand-written kernels, from the
shapes the harness sent: each input byte read once and each output byte
written once over HBM bandwidth, against the operations over the peak
rate, the larger of the two. Frozen copies of ``chip_smoke.py``'s
``attention_bound`` (K3) and ``wkv_bound`` (K4), in seconds, plus the
byte count of one pack or unpack (K1 / K2)."""
from __future__ import annotations

from typing import Optional

from portbench.yardstick.peaks import BF16_FLOPS, FP32_FLOPS, HBM_BPS


def valid_pairs(sq: int, skv: int, causal: bool,
                window: Optional[int]) -> int:
    """(query, key) pairs the mask keeps, for queries at positions
    ``skv - sq .. skv - 1`` (a prefill: ``sq == skv``)."""
    total = 0
    off = skv - sq
    for i in range(sq):
        q = off + i
        hi = q + 1 if causal else skv
        lo = max(0, q - window + 1) if window is not None else 0
        total += max(0, hi - lo)
    return total


def attention_bound(B: int, Sq: int, Skv: int, H: int, KV: int, dh: int,
                    causal: bool, window: Optional[int],
                    elem_bytes: int = 2) -> float:
    """Seconds: q, k, v read once and the output written once, against
    the two products' FLOPs (4 per kept pair per head per dh) over the
    bf16 peak."""
    nbytes = (2 * B * Sq * H * dh + 2 * B * Skv * KV * dh) * elem_bytes
    flops = 4 * B * H * dh * valid_pairs(Sq, Skv, causal, window)
    return max(nbytes / HBM_BPS, flops / BF16_FLOPS)


def wkv_bound(BH: int, S: int, hs: int, chunk: int) -> float:
    """Seconds of one K4 launch: r, k, v, log_w and s0 read once, y and
    the final state written once (fp32), against the fp32 operations of
    the chunked form over the fp32 rate."""
    nbytes = 4 * (5 * BH * S * hs + 2 * BH * hs * hs)
    pairs = chunk * (chunk - 1) // 2
    per_chunk = (chunk * hs + 6 * pairs * hs + 6 * chunk * hs
                 + 2 * pairs * hs + 2 * chunk * hs * hs
                 + hs + hs * hs + 2 * chunk * hs * hs)
    flops = BH * (S // chunk) * per_chunk
    return max(nbytes / HBM_BPS, flops / FP32_FLOPS)


def pack_bytes(rows: int, sizes) -> int:
    """Bytes one pack (K1) or one unpack (K2) of ``rows`` endpoint rows
    moves: every buffer byte read once and written once."""
    return 2 * rows * sum(int(s) for s in sizes)
