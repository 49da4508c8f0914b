#!/usr/bin/env python3
"""Readings that the output check's limits are set from, on the card.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \\
        [--seconds 2]

For each seed, one run of the cell with a short window (the cell's own
sizes and load): the numbers its kept frames give against the plain
reference (the lower reading), and the numbers that the reference itself
gives in the nearest lower precision, put in the program's place (the
control: its colour arithmetic in bfloat16), which must come out as not
correct.
One JSON line a seed, then one line with the largest program reading and
the smallest control reading of each number.  The benchmark's own runs
never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    # the checkout's root in place of this script's folder, whose modules
    # (trace, check, ...) would shadow the standard library's
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 1

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    worst, best = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                  device="cuda", t_start=time.perf_counter(),
                                  root=ROOT, control=True, log=log)
        prog = {k: v["value"] for k, v in res["checked"].items()}
        for k, v in prog.items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in res["control"].items():
            best[k] = min(best.get(k, v), v)
        print(json.dumps({"seed": seed, "program": prog,
                          "control": res["control"],
                          "shares": [res["program_shares"],
                                     res["control_shares"]],
                          "correct": res["correct"],
                          "metrics": res["metrics"]}), flush=True)
    print(json.dumps({"workload": args.workload, "lower_reading": worst,
                      "control_smallest": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
