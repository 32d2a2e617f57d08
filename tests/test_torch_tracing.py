"""The tracer's spans and counters inside a self-play ply (p3achygo_tpu_torch
/tracing.py, mcts/gumbel.py, mcts/puct.py, selfplay/loop.py).

On the CPU, with a tiny btl network: the span tree of tiered plies and a
reset, results bit-identical with the tracer on and off, nothing recorded
off, the eval rows and the sync wait by cause, the ranges a torch
profiler sees, the summary, and the generation loop's `--trace-spans` line;
with a small transformer: one `trunk.attention` span a block inside
`eval.forward`, none off, the same outputs on and off.
The tests marked `cuda` need a card (the clock a kernel launch shares with
its span's range; the sync count of a planted `.item()` and a boolean-mask
write whose values the mask sizes); this file imports no JAX:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_tracing.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import pytest
import torch

from p3achygo_tpu_torch import tracing
from p3achygo_tpu_torch.game.board import new_state
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts import puct as tp
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.selfplay import loop as tl

B, CAP = 8, 16
# Ranges a benchmark opens around the program (portbench/harness/trace.py).
HARNESS_RANGES = ("step", "search", "nn_eval", "reset")
PARENTS = {
    "selfplay.tier": {"selfplay.step"},
    "selfplay.compact": {"selfplay.tier"},
    "selfplay.record": {"selfplay.step"},
    "search.root": {"selfplay.tier"},
    "search.eval": {"search.root", "search.sweep"},
    "eval.features": {"search.eval"},
    "eval.forward": {"search.eval"},
    "trunk.attention": {"eval.forward"},
    "search.sweep": {"search.root"},
    "search.descent": {"search.sweep"},
    "search.leaf": {"search.sweep"},
    "search.terminal": {"search.sweep"},
    "search.backup": {"search.sweep"},
    "search.rerank": {"search.root"},
}


@pytest.fixture(autouse=True)
def clean_tracer():
    torch.set_num_threads(2)
    tracing.disable()
    tracing.reset()
    tg.COUNTERS.reset()
    yield
    tracing.disable()
    tracing.reset()
    tg.COUNTERS.reset()


@pytest.fixture(scope="module")
def model():
    m = build_model(get_config("tiny"), device="cpu")
    init_params(m, torch.Generator().manual_seed(11))
    return m


class Rows:
    """The eval function with the rows of each call noted."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, states):
        self.rows.append(states.stones.shape[0])
        return self.fn(states)


def play(model, early_stopping=False, terminal_mode="cheap"):
    """Three tiered plies (so the tree is reused) and a reset of every other
    board; -> (the tensors they leave, the eval rows)."""
    cfg = tl.SelfplayConfig(batch_size=B)
    common = dict(max_depth=6, visit_group=2, early_stopping=early_stopping,
                  terminal_mode=terminal_mode)
    sel = tg.SearchParams(n=8, k=4, **common)
    fast = tg.SearchParams(n=4, k=2, **common)
    gen = torch.Generator().manual_seed(5)
    eval_fn = Rows(tg.make_eval_fn(model, use_fused_trunk=True))
    states = new_state(B, cfg.komi, device="cpu")
    buf = tl.make_game_buffer(B, cfg.max_game_len, device="cpu")
    aux = tl.make_aux(B, gen, device="cpu")
    tree = make_tree(B, CAP, device="cpu")
    for _ in range(3):
        states, buf, aux, tree = tl.selfplay_step_tiered(
            states, buf, aux, eval_fn, sel, fast, cfg, generator=gen, reuse_tree=tree,
            reuse_capacity=CAP)
    done = torch.arange(B) % 2 == 0
    states, buf, aux, tree = tl.reset_finished(states, buf, aux, done, cfg.komi,
                                               generator=gen, reuse_tree=tree)
    return [*states, *buf, *aux, *tree], eval_fn.rows


def test_span_tree_of_tiered_plies_and_a_reset(model):
    tracing.enable()
    _, rows = play(model)
    tracing.disable()
    spans = tracing.spans()
    top = [s for s in spans if s.parent < 0]
    assert [s.name for s in top] == ["selfplay.step"] * 3 + ["selfplay.reset"]
    assert len({s.ply for s in top}) == 4
    assert [s.attrs for s in top] == [{"B": B}] * 4
    for s in spans:
        assert s.end is not None and s.start <= s.end, s
        if s.parent < 0:
            continue
        parent = spans[s.parent]
        assert parent.name in PARENTS[s.name], (s, parent)
        assert s.ply == parent.ply
        assert parent.start <= s.start and s.end <= parent.end, (s, parent)
    # One search.eval a call of the eval function, in order, with its rows.
    evals = [s for s in spans if s.name == "search.eval"]
    assert [s.attrs["rows"] for s in evals] == rows
    assert {s.attrs["kind"] for s in evals if spans[s.parent].name == "search.root"} == {"root"}
    assert {s.attrs["kind"] for s in evals if spans[s.parent].name == "search.sweep"} == {"leaf"}
    assert all(s.attrs == {"route": "fused"} for s in spans if s.name == "eval.forward")
    tiers = [s.attrs for s in spans if s.name == "selfplay.tier"]
    assert tiers == [{"n": 8, "k": 4, "rows": 2}, {"n": 4, "k": 2, "rows": 6}] * 3
    roots = [s.attrs for s in spans if s.name == "search.root"]
    assert roots == [{"n": 8, "k": 4, "rows": 2}, {"n": 4, "k": 2, "rows": 6}] * 3
    # A descent syncs once a level it walks, and once more to stop.
    descents = [s.attrs["levels"] for s in spans if s.name == "search.descent"]
    assert sum(descents) + len(descents) == tg.COUNTERS.syncs["descent"]
    assert sum(descents) > 0
    assert [s.name for s in spans if s.ply == top[-1].ply] == ["selfplay.reset"]


def test_results_are_bit_identical_with_the_tracer_on_and_off(model):
    off, rows_off = play(model, early_stopping=True, terminal_mode="exact")
    tracing.enable()
    on, rows_on = play(model, early_stopping=True, terminal_mode="exact")
    tracing.disable()
    assert rows_on == rows_off
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_off_records_nothing(model):
    assert tracing.span("a", n=1) is tracing.span("b")
    assert tracing.ply("selfplay.step") is tracing.span("c")
    play(model, terminal_mode="exact")
    assert tracing.spans() == [] and tracing.summary() == {}
    assert not tracing.is_on()
    assert tg.COUNTERS.syncs["descent"] > 0 and tg.COUNTERS.syncs["exact_terminal"] > 0
    assert dict(tg.COUNTERS.sync_wait_ns) == {}


@pytest.mark.parametrize("early_stopping", [False, True])
def test_positions_count_the_rows_given_to_the_eval_function(model, early_stopping):
    """The rows of the `search.eval` spans (what `search.positions_per_ply`
    reads) are the rows each search call gave the eval function."""
    tracing.enable()
    _, rows = play(model, early_stopping=early_stopping)
    tracing.disable()
    assert [s.attrs["rows"] for s in tracing.spans() if s.name == "search.eval"] == rows
    assert sum(rows) > 0


def test_sync_wait_samples_by_cause_equal_the_syncs(model):
    tracing.enable()
    play(model, early_stopping=True, terminal_mode="exact")
    eval_fn = Rows(tg.make_eval_fn(model))
    states = new_state(4, 7.5, device="cpu")
    tp.search_root_puct(states, eval_fn, tp.PuctParams(n=6, terminal_mode="exact"))
    tracing.disable()
    waits = dict(tg.COUNTERS.sync_wait_ns)
    assert set(waits) == set(tg.COUNTERS.syncs)
    assert set(waits) == {"descent", "early_stop", "exact_terminal", "puct_descent"}
    assert all(ns > 0 for ns in waits.values())
    spans = tracing.spans()
    puct = [s for s in spans if s.parent < 0 and s.name == "search.root"]
    assert [s.attrs for s in puct] == [{"n": 6, "k": 0, "rows": 4}]
    under = [s for s in spans if s.ply == puct[0].ply and s.name == "search.eval"]
    assert [s.attrs["rows"] for s in under] == eval_fn.rows


def _chrome_ranges(prof):
    """[(name, start us, end us)] of the profile's user_annotation events."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda r: r[1])


def test_a_profiled_ply_carries_the_program_ranges(model):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        play(model)
    # The tracer followed the profiler through each ply and is off again.
    assert not tracing.is_on()
    spans = tracing.spans()
    assert [s.name for s in spans if s.parent < 0] == ["selfplay.step"] * 3 + ["selfplay.reset"]
    ranges = _chrome_ranges(prof)
    assert not {r[0] for r in ranges} & set(HARNESS_RANGES)
    assert all("." in r[0] for r in ranges)
    by_name = {}
    for r in ranges:
        by_name.setdefault(r[0], []).append(r)
    assert {n: len(v) for n, v in by_name.items()} == {
        n: d["count"] for n, d in tracing.summary().items()}
    # The k-th range of a name is the k-th span of that name: each nests in
    # its parent's range as the span nests in its parent.
    seen, where = {}, []
    for s in spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        where.append(by_name[s.name][k])
    for s, (_, start, end) in zip(spans, where):
        if s.parent >= 0:
            _, p_start, p_end = where[s.parent]
            assert p_start <= start and end <= p_end, (s, spans[s.parent])
    # Outside a profiler session and with the tracer off, nothing more.
    play(model)
    assert len(tracing.spans()) == len(spans)


def test_summary_counts_total_and_self_time(model):
    tracing.enable()
    play(model)
    tracing.disable()
    spans, summ = tracing.spans(), tracing.summary()
    for name, d in summ.items():
        mine = [s for s in spans if s.name == name]
        assert d["count"] == len(mine)
        assert d["total_s"] == pytest.approx(sum(s.end - s.start for s in mine) / 1e9)
        assert 0 <= d["self_s"] <= d["total_s"] + 1e-12
        assert d["syncs"] == 0  # no card: nothing reports a sync
    top = sum(s.end - s.start for s in spans if s.parent < 0) / 1e9
    assert sum(d["self_s"] for d in summ.values()) == pytest.approx(top)
    tracing.enable()
    with pytest.raises(RuntimeError):
        with tracing.span("x"):
            tracing.reset()


@pytest.fixture(scope="module")
def transformer():
    cfg = dataclasses.replace(get_config("b14d96h3_transformer"), blocks=2, channels=32,
                              embed_dim=32, num_heads=2, head_channels=8, c_val=16)
    m = build_model(cfg, device="cpu")
    init_params(m, torch.Generator().manual_seed(13))
    return m


def transformer_eval(model, states):
    """The eval function's outputs, as a list of tensors."""
    return list(tg.make_eval_fn(model, symmetrize=True)(states)[:4])


def test_attention_spans_one_a_block_inside_the_forward(transformer):
    states = new_state(3, 7.5, device="cpu")
    tracing.enable()
    transformer_eval(transformer, states)
    tracing.disable()
    spans = tracing.spans()
    attn = [s for s in spans if s.name == "trunk.attention"]
    assert len(attn) == transformer.config.blocks == 2
    for s in attn:
        assert s.attrs == {"rows": 3, "tokens": 361, "heads": 2, "head_dim": 16}
        parent = spans[s.parent]
        assert parent.name in PARENTS[s.name] and parent.attrs == {"route": "plain"}
        assert parent.start <= s.start <= s.end <= parent.end
    assert attn[0].end <= attn[1].start


def test_attention_spans_off_record_nothing_and_change_no_output(transformer):
    gen = torch.Generator().manual_seed(3)
    states = new_state(4, 7.5, device="cpu")
    stones = torch.randint(-1, 2, states.stones.shape, generator=gen, dtype=torch.int8)
    states = states._replace(stones=stones)
    off = transformer_eval(transformer, states)
    assert tracing.spans() == []
    tracing.enable()
    on = transformer_eval(transformer, states)
    tracing.disable()
    assert sum(s.name == "trunk.attention" for s in tracing.spans()) == 2
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tracing.reset()
    again = transformer_eval(transformer, states)
    assert tracing.spans() == []
    assert all(torch.equal(a, b) for a, b in zip(again, off))


def test_generation_loop_prints_its_spans(tmp_path, capsys):
    from p3achygo_tpu_torch.rl.__main__ import main

    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "config", "ci-tiny.json")
    main(["--config", config, "--gens", "1", "--run-dir", str(tmp_path), "--device", "cpu",
          "--trace-spans", "--no-resume"])
    tracing.disable()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spans = line["spans"]
    assert spans["selfplay.step"]["count"] > 0
    for d in spans.values():
        assert set(d) == {"count", "total_s", "self_s", "syncs"}
    assert spans["search.descent"]["count"] == spans["search.backup"]["count"]
    assert set(line["sync_wait_s"]) >= {"descent"}
    assert line["preact"] == {"launches": 0, "plain_calls": 0}  # the CPU runs no kernel
    assert tracing.spans() == [] and dict(tg.COUNTERS.sync_wait_ns) == {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device records and the card's "
                    "sync reports exist only there")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_kernel_launch_falls_inside_its_span_range(card):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(1 << 20, device=card)
    torch.cuda.synchronize()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.span("test.outer"):
            y = x * 2.0
            with tracing.span("test.inner"):
                y = torch.sin(y)
        torch.cuda.synchronize()
    tracing.disable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    rng = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e["name"].startswith("test.")}
    kernels = {e["args"]["correlation"]: e["name"] for e in events if e.get("cat") == "kernel"}
    launches = [(float(e["ts"]), kernels.get(e["args"]["correlation"])) for e in events
                if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"]]
    inner = [k for t, k in launches if rng["test.inner"][0] <= t <= rng["test.inner"][1]]
    outer = [k for t, k in launches if rng["test.outer"][0] <= t <= rng["test.outer"][1]]
    assert len(inner) == 1 and "sin" in inner[0].lower(), launches
    assert len(outer) == 2, launches
    # A device record starts after its launch, on the same clock.
    for e in events:
        if e.get("cat") == "kernel" and "sin" in e["name"].lower():
            assert float(e["ts"]) >= rng["test.inner"][0]


@pytest.mark.cuda
def test_the_sync_count_catches_a_planted_item_and_mask_write(card):
    x = torch.randn(4096, device=card)
    torch.cuda.synchronize()
    tracing.enable()
    with tracing.span("test.none"):
        y = x * 2.0
    with tracing.span("test.item"):
        x.sum().item()
    with tracing.span("test.mask"):
        # The mask's true count sizes the values: a sync. (A scalar
        # written through a mask is a masked_fill_, which needs none.)
        m = y > 0
        y[m] = x[m] * 3.0
    tracing.disable()
    syncs = {s.name: s.syncs for s in tracing.spans()}
    assert syncs["test.none"] == 0
    assert syncs["test.item"] >= 1
    assert syncs["test.mask"] >= 1
    # Off, the card's sync reports are back as they were.
    assert torch.cuda.get_sync_debug_mode() == 0
