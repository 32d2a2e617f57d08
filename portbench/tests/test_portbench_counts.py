"""Work counts and metric arithmetic on the CPU: the counts against hand
sums at the two configurations' widths, kernel time per launch when the
profiler drops records, and shares reported as read."""
from __future__ import annotations

import json
import os

import pytest

from portbench.harness import work
from portbench.harness.cells import metric_reader
from portbench.harness.runner import Records
from portbench.harness.trace import Profile

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 361


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("C,cb,blocks", [(128, 64, 3), (384, 192, 5)])
def test_segment_work_is_the_sum_of_its_products(C, cb, blocks):
    macs = P * C * cb + 3 * (P * 9 * cb * cb) + P * cb * C  # reduce, 3 inner 3x3, expand
    flops, nbytes = work.segment_work(512, blocks, 5, C, cb)
    assert flops == 2 * macs * blocks * 512
    weights = blocks * (C * cb + 3 * 9 * cb * cb + cb * C) * 2
    assert nbytes == 512 * P * C * 2 * 2 + weights + blocks * 5 * 2 * C * 4


@pytest.mark.parametrize("C", [128, 384])
def test_broadcast_work_is_the_sum_of_its_products(C):
    macs = P * C * C + C * P * P + P * C * C  # conv_first, mix, conv_last
    flops, nbytes = work.broadcast_work(2880, C)
    assert flops == 2 * macs * 2880
    assert nbytes == 2880 * P * C * 4 + (2 * C * C + P * P) * 2 + P * 4 + 4 * C * 4


def test_model_flops_by_hand():
    # b12c128btl3: blocks 3, 7, 11 broadcast, the rest bottleneck.
    C, cb, hc, cv = 128, 64, 32, 64
    stem = P * 15 * C * 25 + 8 * C
    btl = P * (C * cb + 3 * 9 * cb * cb + cb * C)
    bro = P * C * C * 2 + C * P * P
    policy = 2 * P * C * hc + 2 * hc * hc + P * hc + 2 * hc
    value = P * C * hc + 2 * hc * cv + cv * 14 + 2 * hc * cv + cv + 2 * hc * cv + 800 * cv
    want = 2 * (stem + 9 * btl + 3 * bro + policy + value)
    assert work.model_flops(config("b12c128btl3")) == want
    assert 0.95e9 < want < 1.1e9
    assert 10e9 < work.model_flops(config("b14c384btl3")) < 11.5e9


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.liberty_bytes(1024) == 1024 * P * 9


def fake_profile(kernels, launches=None, plies=2):
    """A Profile of hand-made records: kernels (name, start ns, end ns)."""
    p = Profile.__new__(Profile)
    p.plies = plies
    p.device_ops = [(n, s, e, i, "kernel") for i, (n, s, e) in enumerate(kernels)]
    p.kernels = list(p.device_ops)
    p.launches = (launches if launches is not None
                  else [(s, i, "kernel") for i, (_, s, _) in enumerate(kernels)])
    p.ranges = []
    p.span = (0, max((e for _, _, e in kernels), default=0))
    return p


def records(kernels, calls, launches=None):
    return Records({"seconds": 1.0, "plies": 2, "moves": 10, "positions": 5, "syncs": 8},
                   fake_profile(kernels, launches), calls, config("b12c128btl3"))


@pytest.mark.parametrize("metric,kernel,calls", [
    ("liberties.roofline", "point_liberties_kernel",
     {"point_liberties_batch": [(1024,)] * 10}),
    ("trunk_segment.roofline", "void trunk_segment_kernel<128, 64>",
     {"trunk_segment": [(3072, 3, 5, 128, 64)] * 10}),
    ("trunk_broadcast.roofline", "void trunk_broadcast_kernel<128>",
     {"trunk_broadcast": [(3072, 128)] * 10}),
])
def test_a_dropped_record_leaves_the_time_per_launch(metric, kernel, calls):
    read = metric_reader(metric)
    every = [(kernel, 1000 * i, 1000 * i + 3000) for i in range(10)]
    whole = read(records(every, calls))
    some = read(records(every[:7], calls))  # three records dropped
    assert some == pytest.approx(whole)
    # The share follows the time a launch: half the time, twice the share.
    faster = [(kernel, 1000 * i, 1000 * i + 1500) for i in range(10)]
    assert read(records(faster, calls)) == pytest.approx(2 * whole)


def test_wide_broadcast_adds_its_three_kernels():
    read = metric_reader("trunk_broadcast.roofline")
    names = ["trunk_broadcast_first_kernel<384>", "trunk_broadcast_mix_kernel<384>",
             "trunk_broadcast_last_kernel<384>"]
    ks = [(n, 0, 1000 * (j + 1)) for _ in range(4) for j, n in enumerate(names)]
    got = read(records(ks, {"trunk_broadcast": [(256, 384)] * 4}))
    bound = work.bound_s(*work.broadcast_work(256, 384))
    assert got == pytest.approx(100 * bound / (6000e-9))


def test_a_share_is_reported_as_read_not_clipped():
    read = metric_reader("liberties.roofline")
    # A kernel record shorter than the bytes allow reads above 100%: the
    # reader reports it as it is, so a miscount shows.
    got = read(records([("point_liberties_kernel", 0, 10)], {"point_liberties_batch": [(8192,)]}))
    assert got > 105


def test_readers_find_nothing_without_records():
    for name in ("liberties.roofline", "trunk_segment.roofline", "trunk_broadcast.roofline",
                 "nn_eval.device_ms_per_ply", "device.idle_share", "step.kernels_per_ply"):
        assert metric_reader(name)(records([], {})) is None, name
    rec = Records({"seconds": 2.0, "plies": 4, "moves": 10, "positions": 1000, "syncs": 80},
                  None, {}, config("b12c128btl3"))
    assert metric_reader("search.syncs_per_ply")(rec) == 20
    mfu = metric_reader("selfplay_mfu")(rec)
    assert mfu == pytest.approx(100 * 1000 * work.model_flops(config("b12c128btl3")) / 2.0 / 989e12)


def test_idle_share_and_kernels_per_ply():
    ks = [("a", 0, 100), ("b", 50, 150), ("c", 300, 400)]
    rec = records(ks, {}, launches=[(0, 0, "kernel"), (10, 1, "kernel"), (20, 2, "kernel"),
                                    (30, 99, "kernel")])
    assert metric_reader("device.idle_share")(rec) == pytest.approx(100 * (1 - 250 / 400))
    assert metric_reader("step.kernels_per_ply")(rec) == 2.0
    assert rec.profile.dropped_records() == 1


class ChromeTrace:
    """Stands in for a profiler: writes hand-made Chrome-trace events."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_kernels_of_a_graph_launch_count_where_it_was_launched():
    us = lambda ns: ns / 1000.0
    ev = lambda cat, name, start, dur, corr=-1: {
        "ph": "X", "cat": cat, "name": name, "ts": us(start), "dur": us(dur),
        "args": {"correlation": corr}}
    events = [
        ev("user_annotation", "step", 0, 10000),
        ev("user_annotation", "nn_eval", 100, 2000),
        ev("cuda_runtime", "cudaLaunchKernel", 200, 10, corr=1),
        ev("cuda_runtime", "cudaGraphLaunch", 300, 10, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 5000, 10, corr=3),  # its record dropped
        ev("cuda_runtime", "cudaStreamSynchronize", 6000, 10, corr=4),
        ev("kernel", "stem", 400, 100, corr=1),
        ev("kernel", "trunk_a", 600, 200, corr=2),
        ev("kernel", "trunk_b", 900, 300, corr=2),
        ev("kernel", "heads", 1300, 400, corr=2),
    ]
    p = Profile(ChromeTrace(events), plies=1)
    assert [kind for _, _, kind in p.launches] == ["kernel", "graph", "kernel"]
    assert p.range_kernel_ns("nn_eval") == (1000.0, 2, 2)
    assert p.kernel_count() == 5
    assert p.dropped_records() == 1
    rec = Records({"seconds": 1.0, "plies": 1, "moves": 1, "positions": 1, "syncs": 0}, p, {},
                  config("b12c128btl3"))
    assert metric_reader("step.kernels_per_ply")(rec) == 5
    assert metric_reader("nn_eval.device_ms_per_ply")(rec) == pytest.approx(1000 / 1e6)
