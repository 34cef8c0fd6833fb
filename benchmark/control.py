"""The control and the planted faults on the card, at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds <a,b,c> \
        --seconds <s> [--fault control|stale|answer|half|byte|none]

One set-up, then the fault planted underneath (`faults.py`; `none`: the
sound program), then for each seed one window and its check, as a run of
`run.py` makes them.  Prints one JSON line per seed: the seed,
`correct`, the numbers compared with their limits, and the requests'
seconds.  The benchmark's own runs never plant a fault.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def main() -> int:
    from benchmark.faults import FAULTS
    from benchmark.harness import Cell
    from benchmark.spec import Spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="control",
                    choices=sorted(FAULTS) + ["none"])
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = Cell(Spec.load(), args.workload)
    cell.warm_up(seeds[0])
    print(json.dumps({"setup_s": time.time() - T_START}), flush=True)
    if args.fault != "none":
        FAULTS[args.fault](cell.system)
    for i, seed in enumerate(seeds):
        out = cell.measure(seed, args.seconds, False, None,
                           close=i == len(seeds) - 1)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": out["correct"], "checks": out["checks"],
                          "request_s": out["info"]["request_s"],
                          "check_s": out["info"]["check_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
