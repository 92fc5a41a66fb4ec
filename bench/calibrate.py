"""Readings that the correctness limits are set from, many seeds in one
process (the card, the kernels and the imports paid once).

    python3 bench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 ... \
        [--control | --fault <name>]

For each seed: a run of the cell as ``bench/run.py`` makes it (its own
pool, its window of ``--seconds``) and the numbers it compares; with
``--control``, the control put in the program's place over the same
traffic; with ``--fault``, the program broken underneath by a fault of
``bench/faults.py``. Prints one JSON line a seed, then the largest and
smallest reading of each number.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse
    import json

    import pytest
    import torch

    from bench import faults, harness, manifest

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        with pytest.MonkeyPatch.context() as mp:
            if args.fault:
                faults.FAULTS[args.fault](mp, cell.entry)
            result, _ = harness.run_cell(cell, seed, args.seconds, False, device="cuda:0",
                                         control=args.control)
        row = {"seed": seed, "control": args.control, "fault": args.fault,
               "correct": result["correct"],
               "attempted": result["attempted"], "failed": result["failed"],
               "checks": {k: v["value"] for k, v in result["checks"].items()},
               "metrics": {k: v["value"] for k, v in result["metrics"].items()},
               "wall_s": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for k in rows[0]["checks"]:
        vals = [r["checks"][k] for r in rows]
        print(f"{k}: largest {max(vals)}, smallest {min(vals)} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]     # the benchmark and the program
    sys.exit(main())
