"""Serve a small model of the PyTorch port with batched requests
(prefill + decode loop with KV caches / recurrent states), as
``examples/serve_batched.py`` does with the reference's engine.

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch rwkv6-1.6b]
    PYTHONPATH=src python examples/torch_serve_batched.py --tiny --device cpu

The model is the reduced (fp32) form of ``--arch``, with random weights
from seed 0. On ``--device cuda`` (the default) the prefill runs the
hand-written flash attention kernel (dense models) or WKV kernel
(``rwkv6-1.6b``); ``--device cpu`` runs their plain versions.
``--tiny`` serves fewer, shorter requests (a smoke run).
"""
import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.launch.serve import init_model
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv: Optional[List[str]] = None) -> List[np.ndarray]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--tiny", action="store_true",
                    help="two small batches of 4 new tokens (a smoke run)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is visible; pass --device cpu")

    acfg, params = init_model(args.arch, reduced=True, device=args.device)
    new = 4 if args.tiny else 16
    engine = ServeEngine(acfg, params, ServeConfig(
        max_seq=96, max_new_tokens=new, temperature=0.8))
    rng = np.random.default_rng(0)
    outs = []
    for i, batch in enumerate((2, 4) if args.tiny else (2, 4, 8)):
        prompts = rng.integers(0, acfg.model.vocab_size, (batch, 24),
                               dtype=np.int32)
        t0 = time.perf_counter()
        out = engine.generate(prompts)
        dt = time.perf_counter() - t0
        print(f"[{args.arch} on {args.device}] request {i}: batch={batch} "
              f"generated {out.shape[1]} tokens/seq in {dt * 1e3:.0f} ms "
              f"({out.size / dt:.0f} tok/s)")
        print(f"   first seq: {out[0].tolist()}")
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
