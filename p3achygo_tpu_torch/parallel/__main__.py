"""Run the multi-rank dry run (parallel/dryrun.py) over N ranks on one host:

    python -m p3achygo_tpu_torch.parallel --nproc N [--device cpu]

Starts N processes joined by torch.distributed through a TCP rendezvous on
a free localhost port: NCCL, one card per rank, by default; gloo with
`--device cpu`. NCCL takes one rank per card, so a machine with one card
runs `--nproc 1` on it; more ranks need as many cards, or the CPU. Each
rank runs `dryrun_multichip(N)`; rank 0 prints its summary as one JSON
line. The exit code is 0 only if every rank passed.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import socket
import sys

from p3achygo_tpu_torch.parallel.dryrun import run_rank

RANK_TIMEOUT_S = 600


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m p3achygo_tpu_torch.parallel",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, required=True, help="ranks to start")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card per rank (the default); cpu: gloo")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    errors = ctx.Queue()
    procs = [ctx.Process(target=run_rank, args=(r, args.nproc, port, args.device, errors))
             for r in range(args.nproc)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    while not errors.empty():
        rank, tb = errors.get()
        print(f"rank {rank} failed:\n{tb}", file=sys.stderr)
    if failed:
        print(f"dryrun_multichip: ranks {failed} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
