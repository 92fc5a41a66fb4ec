"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the result as the last line of
standard output and the numbers compared, each beside its limit, as the
last lines of standard error (``bench/harness.py``).
"""

import time

T0 = time.perf_counter()      # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's package, and the program under test (src/repro_torch)
sys.path[:1] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from bench import harness

    sys.exit(harness.main(t0=T0))
