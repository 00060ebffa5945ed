#!/usr/bin/env python3
"""Times the port's flash attention kernel (K3) at the shapes
``chip_smoke.py``'s ``[kernel]`` phase gives it, beside its plain
version and SDPA, on one NVIDIA GPU:

    python3 tools/bench_k3.py [--src DIR] [--label NAME] [--shapes a,b]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two versions of the kernel can be
compared in one run on one card: unpack the other commit with ``git
archive`` into a directory that ``.gitignore`` lists and call the script
once with each ``--src`` in turns (A, B, B, A). Each kernel builds into
its own tree's ``build/kernels/``.

The timing is ``chip_smoke.k3_times`` (warm and with L2 flushed; SDPA
takes no softcap and runs without it where the shape has one). Per shape
it prints that phase's ``[kernel]`` lines, then one JSON line with the
times, the bound, the path the kernel took and its max |diff| and
largest per-tile error (``chip_smoke.tile_rel``) against plain. The
first line is the card's name and power limit. Exits 1 without a card."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def shapes() -> dict:
    """name: (B, S, H, KV, dh, causal, softcap, q scale), from the
    [kernel] phase's constants."""
    out = {"qwen3-8b prefill": (cs.BATCH, cs.PROMPT_LEN, *cs.QWEN3_HEADS,
                                True, None, 1.0),
           "qwen3-8b training": (cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                 *cs.QWEN3_HEADS, True, None, 1.0)}
    for arch, (*shape, causal) in cs.FA_HEAD_DIM_SHAPES.items():
        out[arch] = (*shape, causal, None, 1.0)
    for arch, (*shape, cap) in cs.FA_PREFILL_SHAPES.items():
        out[f"{arch} prefill"] = (*shape, True, cap, 1.0)
    *shape, cap = cs.FA_PREFILL_SHAPES["gemma2-9b"]
    out["gemma2-9b prefill past the softcap"] = (
        *shape, True, cap, cs.SOFTCAP_Q_SCALE)
    return out


def main(argv=None) -> int:
    table = shapes()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--shapes", default=",".join(table),
                    help="comma-separated names of shapes()")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    name = cs.card()
    print(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in args.shapes.split(","):
        B, S, H, KV, dh, causal, cap, q_scale = table[shape]
        q, k, v = (torch.randn(s, device="cuda", generator=gen)
                   for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh)))
        q, k, v = (t.to(torch.bfloat16) for t in (q * q_scale, k, v))
        out = flash_attention(q, k, v, causal, None, cap)
        ref = attention_plain(q, k, v, causal, None, cap)
        err = (out.float() - ref.float()).abs().max().item()
        tile, _ = cs.tile_rel(out, ref)
        del out, ref
        print(json.dumps({
            "tree": args.label, "shape": shape, "q": list(q.shape),
            "q_scale": q_scale, "kv": KV, "causal": causal, "softcap": cap,
            "max_abs_err": err, "tile_rel_err": tile,
            **cs.k3_times(name, shape, q, k, v, causal, cap)}))
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
