"""The readers of the program's spans and counters, on the CPU.

- Each new reader on a hand-made profile whose program spans sit at a
  known offset from the profiler's clock: the idle time under a span, the
  forward's kernels, the counters a ply.
- The eight readers that came before read the same number from a profile
  with and without the program's ranges in it.
- A traced run of a small cell on the CPU: the spans laid over the
  profile by the harness's ranges land where the profiler put the
  program's own ranges, and the counter readers read the run's counts.
"""
from __future__ import annotations

import json
import os
import tempfile

import pytest
import torch

from portbench.harness import program_spans
from portbench.harness.cells import metric_reader
from portbench.harness.runner import Records
from portbench.harness.trace import Profile
from p3achygo_tpu_torch import tracing
from p3achygo_tpu_torch.mcts import gumbel

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ("search.descent.idle_ms_per_ply", "search.backup.idle_ms_per_ply",
       "nn_eval.forward_device_ms_per_ply", "search.sync_wait_ms_per_ply",
       "step.syncs_per_ply", "search.positions_per_ply")
OLD = ("step.kernels_per_ply", "search.syncs_per_ply", "liberties.roofline",
       "nn_eval.device_ms_per_ply", "trunk_segment.roofline", "trunk_broadcast.roofline",
       "device.idle_share", "selfplay_mfu")
D = 7_000_000  # profile ns - program ns
US = 1000


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.reset()
    gumbel.COUNTERS.reset()
    program_spans._cache.clear()
    yield
    tracing.disable()
    tracing.reset()
    gumbel.COUNTERS.reset()
    program_spans._cache.clear()


def span(name, start, end, parent=-1, ply=0, **attrs):
    s = tracing.Span(name, start * US, parent, ply, attrs)
    s.end = end * US
    return s


def ply_spans():
    """One ply in program us: a step holding a search whose root eval runs
    the forward, then a sweep of descent, leaf eval and backup."""
    return [
        span("selfplay.step", 10, 1000, B=4),                                # 0
        span("search.root", 20, 900, 0, n=8, k=4, rows=4),                   # 1
        span("search.eval", 30, 200, 1, kind="root", rows=4),                # 2
        span("eval.forward", 50, 190, 2, route="fused"),                     # 3
        span("search.sweep", 300, 800, 1, k_r=4, group=2),                   # 4
        span("search.descent", 300, 500, 4, levels=3),                       # 5
        span("search.eval", 520, 600, 4, kind="leaf", rows=32),              # 6
        span("search.backup", 650, 790, 4),                                  # 7
    ]


def events(with_program=True, spans=None):
    """A Chrome trace of the ply: the harness's ranges around the program's
    (a few us of slack), two kernels launched inside the root's forward and
    one in the leaf eval, and, with `with_program`, the program's own
    ranges at their true places."""
    spans = spans or ply_spans()
    ev = []

    def x(cat, name, t0, t1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0 + D / US, "dur": t1 - t0,
                   "args": args})

    x("user_annotation", "step", 8, 1003)
    x("user_annotation", "search", 18, 902)
    x("user_annotation", "nn_eval", 33, 197)
    x("user_annotation", "nn_eval", 523, 598)
    for corr, (launch, k0, k1) in enumerate([(60, 70, 120), (100, 130, 180),
                                             (540, 560, 590)]):
        x("cuda_runtime", "cudaLaunchKernel", launch, launch + 3, correlation=corr)
        x("kernel", f"kernel_{corr}", k0, k1, correlation=corr)
    if with_program:
        for s in spans:
            x("user_annotation", s.name, s.start / US, s.end / US)
    return ev


class FakeProf:
    def __init__(self, ev):
        self.ev = ev

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.ev}, f)


def records(ev, plies=1):
    calls = {"point_liberties_batch": [(1024,)] * 4, "trunk_segment": [(1024, 3, 5, 128, 64)],
             "trunk_broadcast": [(1024, 128)]}
    with open(os.path.join(BENCH, "configs", "b12c128btl3.json")) as f:
        config = json.load(f)
    return Records({"seconds": 2.0, "plies": 4, "moves": 4000, "positions": 228, "syncs": 40},
                   Profile(FakeProf(ev), plies), calls, config)


def install(monkeypatch, spans, wait_ns=()):
    monkeypatch.setattr(tracing, "_records", spans)
    for ns in wait_ns:
        gumbel.COUNTERS.sync_wait_ns["descent"] += ns


def test_each_new_reader_on_a_profile_at_a_known_offset(monkeypatch):
    spans = ply_spans()
    spans[5].syncs, spans[7].syncs, spans[0].syncs = 4, 1, 2
    install(monkeypatch, spans, wait_ns=(300_000, 200_000))
    rec = records(events())
    ov = program_spans.overlay(rec)
    assert ov is not None and ov.plies == [0]
    # The pairs bound the offset to within their slack; every edge lands
    # within the bracket's width of its true place.
    lo, hi = ov.used[0]
    assert lo <= D <= hi and hi - lo <= 6 * US
    for s, (m0, m1) in zip(spans, ov.mapped):
        assert abs(m0 - (s.start + D)) <= hi - lo and abs(m1 - (s.end + D)) <= hi - lo
    read = lambda name: metric_reader(name)(rec)
    # Busy: the three kernels, [70, 120], [130, 180], [560, 590]; the span
    # runs from the step range's start (8) to its end (1003).
    idle = ov.idle_by_span()
    assert sum(idle.values()) == pytest.approx(rec.profile.span_s - rec.profile.busy_s())
    assert read("search.descent.idle_ms_per_ply") == pytest.approx(0.2, abs=0.007)
    assert read("search.backup.idle_ms_per_ply") == pytest.approx(0.14, abs=0.007)
    assert read("nn_eval.forward_device_ms_per_ply") == pytest.approx(0.1)  # 50 + 50 us
    assert read("search.sync_wait_ms_per_ply") == pytest.approx(0.5)
    assert read("step.syncs_per_ply") == 7
    assert read("search.positions_per_ply") == 36
    # Two plies' worth of profile halves each.
    rec2 = records(events(), plies=2)
    assert metric_reader("step.syncs_per_ply")(rec2) == 3.5
    assert metric_reader("search.positions_per_ply")(rec2) == 18


def test_idle_outside_every_span_is_named_none(monkeypatch):
    install(monkeypatch, ply_spans())
    ov = program_spans.overlay(records(events()))
    idle = ov.idle_by_span()
    # The step range opens 2 us before the program's step and closes 3 us after.
    assert idle[program_spans.NONE] == pytest.approx(5e-6, abs=3e-6)
    assert idle["eval.forward"] == pytest.approx((140 - 100) * 1e-6, abs=6e-6)


def test_the_readers_find_nothing_without_the_program_tracer(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: None)
    rec = records(events(with_program=False))
    for name in NEW:
        assert metric_reader(name)(rec) is None, name
    install(monkeypatch, [])
    monkeypatch.setattr(program_spans, "records", lambda: [])
    for name in NEW:
        assert metric_reader(name)(rec) is None, name


def test_the_eight_readers_read_the_same_with_program_ranges_in_the_profile(monkeypatch):
    install(monkeypatch, ply_spans())
    ev = events(with_program=False)
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": D / US + t, "dur": 10,
            "args": {"correlation": 100 + i}}
           for i, (n, t) in enumerate([("point_liberties_kernel", 610),
                                       ("void trunk_segment_kernel<128, 64>", 640),
                                       ("void trunk_broadcast_kernel<128>", 700)])]
    without = {name: metric_reader(name)(records(ev)) for name in OLD}
    with_ = {name: metric_reader(name)(records(ev + events()[-len(ply_spans()):]))
             for name in OLD}
    assert all(v is not None for v in without.values()), without
    assert with_ == without
    # The new readers read the same either way too: they take the spans
    # from the program, not from the profile's ranges.
    program_spans._cache.clear()
    a = {n: metric_reader(n)(records(ev)) for n in NEW}
    program_spans._cache.clear()
    b = {n: metric_reader(n)(records(ev + events()[-len(ply_spans()):])) for n in NEW}
    assert a == b


def test_a_traced_cpu_run_lays_the_spans_where_the_profiler_put_them():
    from test_portbench_faults import CHECK, SEED, small_cell
    from portbench.harness.cellrun import CellRun

    torch.set_num_threads(2)
    run = CellRun(small_cell(), SEED, torch.device("cpu"), True, lambda m: None, check=CHECK)
    run.warm()
    window = run.window(0.05)
    assert tracing.spans() == []  # the window is not traced
    prof, _ = run.profiled_plies(2)
    spans = tracing.spans()
    tops = [s.name for s in spans if s.parent < 0]
    assert tops.count("selfplay.step") == 2 and set(tops) <= {"selfplay.step", "selfplay.reset"}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    true = {}
    for e in ev:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and "." in e["name"]:
            t0 = int(round(float(e["ts"]) * 1000))
            true.setdefault(e["name"], []).append((t0, t0 + int(round(float(e["dur"]) * 1000))))
    for v in true.values():
        v.sort()
    profile = Profile(FakeProf(ev), 2)  # a trace is exported once
    ov = program_spans.Overlay(profile, spans)
    assert set(ov.offset) == {s.ply for s in spans if s.parent < 0}
    width = ov.width_ns()
    assert 0 <= width < 200_000, ov.bounds  # ns
    # A span's clock readings enclose its profiler range, so each span,
    # placed, encloses its range to within the bounds' width (and no more
    # than the range's own cost on this host wider).
    seen, wider = {}, 0
    for s, (m0, m1) in zip(spans, ov.mapped):
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        t0, t1 = true[s.name][k]
        assert m0 <= t0 + width and t1 - width <= m1, (s, (m0, m1), (t0, t1), width)
        wider = max(wider, t0 - m0, m1 - t1)
    assert wider < 1_000_000, wider
    rec = Records(window, profile, {}, run.cell["config"])
    per_ply = window["positions"] / window["plies"]
    assert metric_reader("search.positions_per_ply")(rec) == per_ply
    assert metric_reader("search.sync_wait_ms_per_ply")(rec) > 0
    assert metric_reader("step.syncs_per_ply")(rec) == 0  # no card reports a sync
    run.free_program()
