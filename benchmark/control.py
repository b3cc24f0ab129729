"""The readings a cell's limits are set from, in one process: the program's
numbers compared on many seeds (the lower readings) and the control's, the
plain reference with one guarantee broken put in the program's place
(the upper readings). The benchmark's own runs never run the control.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 5

Each seed's run is the benchmark's run at the cell's own size and load, for
``--seconds``; one JSON line per run on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path if Path(p or ".").resolve() != HERE]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, args.device, control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control" if control else "program",
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "checks": res["checks"],
                          "batches": res["_info"]["batches"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
