"""Readings of the correctness check on several seeds in one process: the
program as a cell runs it, or its lower-precision control.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 5 [--route serveq]

The control is the program's own int8 serving path (the "serveq" route:
`nn/serve_q.py`, calibrated on 256 of the cell's start positions) in place
of the cell's bf16 route, at the cell's own size and load: the nearest
precision below bf16 that the program has. Each seed's numbers print as one JSON line; the
benchmark's own runs never run this. The limits in limits/<cell>.json sit
between the sound runs' largest readings and the control's smallest.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(workload: str, seeds, seconds: float, route, device, cell=None,
             log=lambda m: None, check=None):
    """[(seed, correct, {number: value}, moves/s)] of one run a seed, through
    `route` (None: the traffic's own); `check` as `CellRun` takes it."""
    from portbench.harness.cells import load_cell
    from portbench.harness.runner import run_cell

    cell = cell or load_cell(workload)
    out = []
    for seed in seeds:
        res = run_cell(cell, seed, seconds, False, device, time.perf_counter(), log,
                       route=route, check=check)
        out.append((seed, res["correct"], {k: v["value"] for k, v in res["checks"].items()},
                    res["metrics"]["selfplay_moves_per_s"]["value"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--route", default=None, help="a route of cellrun.ROUTES (default: the "
                    "traffic's)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    log = lambda m: print(m, file=sys.stderr, flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, correct, nums, rate in readings(args.workload, seeds, args.seconds, args.route,
                                              torch.device("cuda", 0), log=log):
        print(json.dumps({"workload": args.workload, "seed": seed, "route": args.route,
                          "correct": correct, "numbers": nums, "moves_per_s": rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
