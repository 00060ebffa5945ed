"""Runs one cell of the port's benchmark once and prints its result as
the last line of standard output:

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout; the port is imported from ``src/``. Build
and kernel caches go under ``build/`` in the checkout."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
