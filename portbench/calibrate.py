"""The readings that the limits in portbench/limits/ are set from: the
compared numbers of sound runs over many seeds, and the control's (the
reference in bfloat16 put in the program's place), in one process.  The
benchmark's own runs do not run this.

    python3 portbench/calibrate.py --workload su3_32.hb_hw \
        --seeds 11,12,13 --control-seeds 11 --seconds 2 \
        --out cal.jsonl

Each seed is a whole run (set-up, a short window at the cell's load, the
check); a line of JSON per seed goes to --out and to standard output.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            t = time.perf_counter()
            rec, checks = harness.run_cell(args.workload, seed, args.seconds,
                                           False, control=seed in control)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "seconds": time.perf_counter() - t,
                               "correct": rec["correct"],
                               "readings": rec["readings"],
                               "control": rec.get("control"),
                               "metrics": rec["metrics"],
                               "device": rec["device"], "checks": checks})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
