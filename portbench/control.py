"""Readings of the correctness check on several seeds in one process: the
program as a cell runs it, or a lower-precision control.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 5 [--route e4m3]

A control is a route of `cellrun.ROUTES` in place of the cell's bf16
route, at the cell's own size and load: "serveq", the program's own int8
serving path (`nn/serve_q.py`, calibrated on 256 of the cell's start
positions), or "e4m3", the plain route with every product's weight and
input rounded to float8 e4m3 by the harness, which every trunk type has.
A route whose eval output equals the traffic route's bit for bit on 8 of
the cell's start positions is no control: it is refused before any
reading, naming the route. Each seed's numbers print as one JSON line;
the benchmark's own runs never run this. The limits in limits/<cell>.json
sit between the sound runs' largest readings and the control's smallest.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SAME_POSITIONS = 8


def same_forward(cell: dict, route: str, seed: int, device) -> bool:
    """Whether `route`'s eval output equals the traffic route's bit for bit
    on the first `SAME_POSITIONS` of the cell's start positions, on the
    cell's weights for `seed`."""
    import torch

    from p3achygo_tpu_torch.game.board import from_stones
    from portbench.harness.cellrun import build_eval_fn, start_positions
    from portbench.harness.weights import make_weights

    tr = cell["traffic"]
    params = make_weights(cell["config"], seed, device, cell["bench_dir"])
    st, tm = start_positions(tr["batch"], tr["start_plies_max"], seed)
    states = from_stones(torch.from_numpy(st[:SAME_POSITIONS]), tr["komi"],
                         torch.from_numpy(tm[:SAME_POSITIONS]), device=device)
    outs = [build_eval_fn(cell, params, r, seed, device)[1](states) for r in (route, tr["route"])]
    return all(torch.equal(a, b) for a, b in zip(*outs) if a is not None)


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

    from portbench.harness.cells import load_cell

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    log = lambda m: print(m, file=sys.stderr, flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    if (args.route not in (None, cell["traffic"]["route"])
            and same_forward(cell, args.route, seeds[0], device)):
        log(f"control: route {args.route!r} gives the eval output of the cell's own route "
            f"{cell['traffic']['route']!r} bit for bit on {SAME_POSITIONS} start positions: it "
            f"is no control of {args.workload}")
        return 4
    for seed, correct, nums, rate in readings(args.workload, seeds, args.seconds, args.route,
                                              device, cell=cell, log=log):
        print(json.dumps({"workload": args.workload, "seed": seed, "route": args.route,
                          "correct": correct, "numbers": nums, "moves_per_s": rate}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
