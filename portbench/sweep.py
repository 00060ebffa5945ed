"""The knee sweep of a serving cell: one set-up, then a window at each
rate in turn, each reported as a JSON line (rate, requests due,
completed by the close, the drain past it, ``ttft_p90_ms``,
``tpot_p95_ms``, the decode op's mean ms). The knee is the highest rate
at which the backlog does not grow: every request due is done within
about one request's time of the close.

  python3 portbench/sweep.py --workload <cell> --rates 0.8,1.2,1.6 \
      --seconds 40 --seed 1 [--out sweep.jsonl]"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness, traffic  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    harness.setup_env()
    h = harness.Harness(args.workload, args.seed, args.seconds, False,
                        t_start=T_START)
    drv = harness.load_module(h.dir / "drivers" / f"{h.mix['kind']}.py",
                              "portbench_driver")
    srv = drv.Served(h)
    srv.warm_up()
    print(f"card {harness.power_limit()}; set-up "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    with open(args.out or os.devnull, "a") as out:
        for rate in (float(r) for r in args.rates.split(",")):
            sweep_one(h, drv, srv, args, rate, out)
    return 0


def sweep_one(h, drv, srv, args, rate: float, out) -> None:
    """One window at ``rate``, reported as a JSON line."""
    srv.reset()
    reqs = traffic.serve_requests(h.mix, rate, args.seconds, args.seed)
    prompts = [traffic.prompt_tokens(args.seed, r, srv.vocab)
               for r in reqs]
    w = srv.window(reqs, prompts, args.seconds,
                   drain_s=h.mix["drain_cap_s"])
    ops = srv.engine.op_seconds["decode"]
    line = json.dumps({
        "workload": args.workload, "rate_rps": rate, "due": len(reqs),
        "completed": len(reqs) - w["bad"],
        "drain_s": w["end"] - w["close"],
        "served_tok_s": w["served_tok_s"],
        "ttft_p90_ms": 1e3 * drv.nearest_rank(w["ttft"], 0.90),
        "tpot_p95_ms": 1e3 * drv.nearest_rank(w["gaps"], 0.95),
        "decode_op_ms": 1e3 * sum(ops) / max(len(ops), 1),
        "late_max_ms": 1e3 * max(w["late"], default=0.0)})
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


if __name__ == "__main__":
    sys.exit(main())
