"""One run of a cell from set-up to the result line's contents."""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from portbench.harness.cellrun import CellRun
from portbench.harness.cells import BENCH_DIR, read_metrics
from portbench.harness.check import judge
from portbench.harness.trace import Profile


class Records:
    """What the per-layer readers read: the window's counts (`window`:
    seconds, plies, moves, positions, syncs), the profile of the profiled
    plies (`profile`, a `trace.Profile`, None in an untraced run), the
    kernel entry points' call shapes in those plies (`calls`), the
    configuration (`config`) and the benchmark's folder its trunk module is
    found in (`bench_dir`)."""

    def __init__(self, window: dict, profile: Optional[Profile], calls: dict, config: dict,
                 bench_dir: str = BENCH_DIR):
        self.window, self.profile, self.calls, self.config = window, profile, calls, config
        self.bench_dir = bench_dir


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             log: Callable = print, **run_kw) -> dict:
    """Runs `cell` once; returns the result's fields and `checks`, the
    numbers compared with their limits."""
    run = CellRun(cell, seed, device, trace, log, **run_kw)
    run.warm()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s ({run.plies_played} warm plies)")
    window = run.window(seconds)
    log(f"window: {window['plies']} plies, {window['moves']} moves, {window['positions']} "
        f"positions evaluated, {window['syncs']} search syncs in {window['seconds']:.4f} s")
    prof = calls = None
    if trace:
        prof, calls = run.profiled_plies(cell["traffic"]["profiled_plies"])
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    events = run.recorder.to_host()
    run.free_program()

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {}
    if trace:
        t0 = time.perf_counter()
        profile = Profile(prof, cell["traffic"]["profiled_plies"])
        del prof
        log(f"trace: {len(profile.device_ops)} device records, {len(profile.launches)} launch "
            f"records, {profile.dropped_records()} launches without a device record, "
            f"{len(profile.ranges)} harness ranges, span {profile.span_s:.4f} s; idle by host "
            f"range {profile.idle_by_range()}; read in {time.perf_counter() - t0:.1f} s")
        rec = Records(window, profile, calls, cell["config"], cell["bench_dir"])
        metrics = read_metrics(cell, rec)
        dev["busy_s"] = profile.busy_s()
        dev["window_s"] = profile.span_s
        out["breakdown"] = {"device_ops": profile.top_ops(10), "idle_gaps": profile.idle_gaps(10)}
    else:
        metrics = {"selfplay_moves_per_s": {"value": window["moves"] / window["seconds"],
                                            "unit": "moves/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    t0 = time.perf_counter()
    correct, failed, numbers = judge(run, events, cell["limits"], device, log)
    log(f"check took {time.perf_counter() - t0:.1f} s")
    return {"correct": correct, "attempted": window["moves"], "failed": failed,
            "metrics": metrics, "device": dev, **out,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}}
