"""Readings that set a cell's limits: the program's compared numbers
over many seeds and the control's (the reference, in the precision
below the configuration's, put in the program's place) over some of
them, all in one process, at the cell's own load with a window of
``--seconds``. The benchmark's own runs never run the control.

  python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
      --control-seeds 1,2,3 --seconds 15 [--out readings.jsonl]

One JSON line a seed: ``compared`` (the program's), ``control`` (where
run, by variant) and the end-to-end metrics."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", default="fp8",
                    help="control variants, comma-separated (fp8, "
                         "fp8_tensor; a training cell also half)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    harness.setup_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args.out or os.devnull, "a") as out:
        return _run(args, out)


def _run(args, out) -> int:
    import torch
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    print(f"card {harness.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        h = harness.Harness(args.workload, seed, args.seconds, False,
                            t_start=time.perf_counter())
        result, _, notes = harness.run_cell(
            h, control=args.variants.split(",") if seed in ctrl else ())
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "correct": result["correct"],
                           "compared": result["compared"],
                           "control": result.get("control"),
                           "metrics": result["metrics"],
                           "attempted": result["attempted"],
                           "failed": result["failed"], "notes": notes})
        print(line, flush=True)
        for note in notes:
            print(f"[{args.workload} {seed}] {note}", file=sys.stderr,
                  flush=True)
        out.write(line + "\n")
        out.flush()
        del result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
