#!/usr/bin/env python3
"""Times the port's routed-expert GLU FFN of the MoE decode (K5) at one
token of Mixtral-8x7B (top-2 of 8 experts 4096 x 14336) and of
Granite-4.0-H-Small (top-10 of 72 experts 4096 x 768), in bf16, beside
its plain version (each assignment's weights gathered, then
``torch.bmm``), the dense path it replaces (``models/moe.py``
``_expert_ffn``'s three batched products over every expert, at capacity
1) and its byte bound (the routed experts' weights read once at 3.35
TB/s), on one NVIDIA GPU:

    python3 tools/bench_k5.py

Times are ``chip_smoke.gpu_ms`` (L2 flushed before each call by a
write, CUDA events), the same with L2 flushed by a read
(``read_flushed_ms``) and ``chip_smoke.cuda_ms`` (warm). Per shape it
prints one JSON line: the times, the bound, the share of it the kernel
reaches, the splits, the largest |kernel - plain|, the device time of
each of the kernel's launches (from ``torch.profiler``; the last three
start early and wait, so their times overlap) and the kernel's time as
one CUDA graph, as the decode replays it. The first line is the card's
name and power limit.
Exits 1 without a card."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402

#: name: (k, d, f, E)
SHAPES = {"mixtral-8x7b": (2, 4096, 14336, 8),
          "granite-4.0-h-small": (10, 4096, 768, 72)}


def read_flushed_ms(fn, iters: int = 20) -> float:
    """``chip_smoke.gpu_ms`` with L2 emptied by reading 128 MiB where
    ``gpu_ms`` writes them: its flush leaves 50 MB of dirty lines in L2,
    whose write-back the timed call pays (about 15 us at 3.35 TB/s)."""
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        torch.sum(flush, dim=0, out=sink)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def launch_ms(fn, iters: int = 20) -> dict:
    """Mean device time of each kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t > 0 and "moe_decode" in ev.key:
            name = ev.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out[f"{name} x{ev.count // iters}"] = t / 1e3 / iters
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_k5: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.moe_decode import ops
    from repro_torch.kernels.moe_decode.ref import ACTIVATIONS
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    for name, (k, d, f, E) in SHAPES.items():
        ws = [(torch.randn(s, device="cuda", generator=gen) * n ** -0.5)
              .to(dt) for s, n in (((E, d, f), d), ((E, d, f), d),
                                   ((E, f, d), f))]
        x = torch.randn(1, d, device="cuda", generator=gen).to(dt)
        ids = torch.randperm(E, device="cuda", generator=gen)[:k]
        rows = x.expand(k, d)
        buf = torch.zeros(E, 1, d, device="cuda", dtype=dt)
        buf[ids, 0] = x[0]

        def dense():
            up = torch.bmm(buf, ws[1])
            inner = ACTIVATIONS["silu"](torch.bmm(buf, ws[0])) * up
            return torch.bmm(inner, ws[2])

        calls = {"kernel": lambda: ops.moe_decode_ffn(rows, ids, *ws),
                 "plain": lambda: ops.moe_decode_plain(rows, ids, *ws,
                                                       "silu"),
                 "dense": dense}
        cold = {key: cs.gpu_ms(fn) for key, fn in calls.items()}
        warm = {key: cs.cuda_ms(fn) for key, fn in calls.items()}
        routed = k * 3 * d * f * 2
        bound = routed / cs.HBM_BPS * 1e3
        err = (ops.moe_decode_ffn(rows, ids, *ws).float()
               - ops.moe_decode_plain(rows, ids, *ws, "silu").float()
               ).abs().max().item()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            ops.moe_decode_ffn(rows, ids, *ws)
        read_ms = {key: read_flushed_ms(fn) for key, fn in calls.items()}
        print(json.dumps({
            "shape": name, "k": k, "d": d, "f": f, "E": E,
            "routed_bytes": routed, "dense_bytes": E * 3 * d * f * 2,
            "bound_ms": bound, "ms_l2_flushed": cold["kernel"],
            "plain_ms_l2_flushed": cold["plain"],
            "dense_ms_l2_flushed": cold["dense"], "ms_warm": warm["kernel"],
            "plain_ms_warm": warm["plain"], "dense_ms_warm": warm["dense"],
            "bound_share_pct": 100.0 * bound / cold["kernel"],
            "ms_l2_read_flushed": read_ms["kernel"],
            "plain_ms_l2_read_flushed": read_ms["plain"],
            "dense_ms_l2_read_flushed": read_ms["dense"],
            "graph_ms_l2_read_flushed": read_flushed_ms(graph.replay),
            "bound_share_read_flushed_pct": 100.0 * bound / read_ms["kernel"],
            "splits_up": ops.splits(d, f, 2 * k, dt),
            "splits_down": ops.splits(f, d, k, dt),
            "max_abs_err": err,
            "launch_ms": launch_ms(calls["kernel"])}))
        del ws, buf, graph
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
