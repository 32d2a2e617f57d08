"""The transformer cell's pieces on the CPU: its two attention readers on a
hand-made profile (and nothing read where the program opens no
`trunk.attention` span, as before the spans existed), and a run of the
cell at a small size (2 blocks, width 32, 2 heads, 8 boards) that comes
out correct as it stands and not correct with the q / sqrt(D) scale
dropped from the program's attention."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from portbench.harness import program_spans
from portbench.harness.attention_work import attention_work
from portbench.harness.cells import load_cell, metric_reader
from portbench.harness.runner import run_cell
from portbench.harness.work import bound_s
from test_portbench_program_spans import events, install, ply_spans, records, span

CELL = "sp.b14d96h3_transformer.refmix.b256.plain"
READERS = ("attention.device_ms_per_ply", "attention.roofline")
SEED = 2 ** 31 + 5252


@pytest.fixture(autouse=True)
def clean():
    program_spans._cache.clear()
    yield
    program_spans._cache.clear()


def test_the_attention_readers_on_a_profile_at_a_known_offset(monkeypatch):
    # Two blocks' attention inside the root's forward (50-190 us), each
    # holding one of its two kernel launches (at 60 and 100 us, 50 us each).
    spans = ply_spans() + [span("trunk.attention", 55, 90, 3, rows=4, tokens=361, heads=3,
                                head_dim=32),
                           span("trunk.attention", 95, 125, 3, rows=4, tokens=361, heads=3,
                                head_dim=32)]
    install(monkeypatch, spans)
    rec = records(events(spans=spans))
    assert metric_reader("attention.device_ms_per_ply")(rec) == pytest.approx(0.1)
    flops, nbytes = attention_work(4, 361, 3, 32)
    assert (flops, nbytes) == (4 * 4 * 3 * 361 ** 2 * 32, 4 * 4 * 361 * 96 * 2)
    want = 100 * bound_s(2 * flops, 2 * nbytes) / 100e-6
    assert metric_reader("attention.roofline")(rec) == pytest.approx(want)
    assert 0.5 < want < 1.0  # bytes-bound: 2.2 MB at 3.35 TB/s over 100 us


def test_the_attention_readers_find_nothing_without_the_spans(monkeypatch):
    install(monkeypatch, ply_spans())
    rec = records(events())
    assert program_spans.overlay(rec) is not None
    for name in READERS:
        assert metric_reader(name)(rec) is None, name
    monkeypatch.setattr(program_spans, "records", lambda: None)
    program_spans._cache.clear()
    for name in READERS:
        assert metric_reader(name)(rec) is None, name


def small_cell():
    cell = copy.deepcopy(load_cell(CELL))
    cell["config"].update(blocks=2, channels=32, embed_dim=32, num_heads=2, head_channels=8,
                          c_val=16)
    tr = cell["traffic"]
    tr.update(batch=8, warm_plies=2, reset_every=2, start_plies_max=60)
    tr["selected"], tr["fast"] = {"n": 8, "k": 4}, {"n": 4, "k": 2}
    # test_portbench_faults.py's limits. The program in bf16 on the CPU reads
    # 0.036 / 0.032 (log-prior, widest row / q75) and 0.004 / 0.003 (value)
    # at this seed; with q unscaled 0.082 / 0.070 and 0.058 / 0.052.
    cell["limits"].update(leaf_logp_gap=0.1, leaf_logp_q75=0.05, leaf_value_gap=0.05,
                          leaf_value_q75=0.02)
    return cell


CHECK = {"boards": 6, "leaf_call_every": 2, "leaf_rows_per_call": 4, "leaf_rows_max": 64}


def unscaled(self, x):
    """The program's attention without q / sqrt(D)."""
    from p3achygo_tpu_torch.models.transformer import softmax

    q, k, v = (p(x).transpose(1, 2) for p in (self.query, self.key, self.value))
    return self.out(torch.matmul(softmax(torch.matmul(q, k.transpose(-1, -2))), v)
                    .transpose(1, 2))


@pytest.mark.parametrize("fault", [None, "q unscaled"])
def test_the_check_passes_the_program_and_fails_an_unscaled_attention(fault, monkeypatch):
    from p3achygo_tpu_torch.models import transformer

    torch.set_num_threads(2)
    if fault:
        monkeypatch.setattr(transformer.MultiHeadDotProductAttention, "forward", unscaled)
    logs = []
    res = run_cell(small_cell(), SEED, 0.05, False, torch.device("cpu"), time.perf_counter(),
                   logs.append, check=CHECK)
    assert res["correct"] == (fault is None), (res["checks"], logs)
    if fault is None:
        assert res["checks"]["rules_mismatches"]["value"] == 0
        assert res["checks"]["search_mismatches"]["value"] == 0
