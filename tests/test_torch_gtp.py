"""The GTP engine of the PyTorch port held against the JAX package's: the
same command scripts into both services give the same responses, over the
uniform evaluator and over the seeded `tiny` network (float32, weights
carried by bridge.py), with the GTP defaults (no root noise, tau 0), so
the moves do not depend on the random draws. lz-analyze's winrate and prior
are rounded float32 values and may differ by 1; everything else is exact.

Also: the time-control budget math, the slice sequence of a timed search
under an injected clock, the REPL on a StringIO and on an os.pipe
(pondering to the visit cap, streamed lz-analyze), undo restoring the
state bit for bit, and `python -m p3achygo_tpu_torch.gtp --device cpu`
with --checkpoint answering genmove as the JAX service over the same bf16
network does. One JAX service per evaluator, module-scoped."""
import dataclasses
import io
import os
import re
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu import gtp as jgtp
from p3achygo_tpu.gtp.time_control import TimeControl as JaxTimeControl
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu_torch import gtp as tgtp
from p3achygo_tpu_torch.game.board import GoState
from p3achygo_tpu_torch.gtp.__main__ import main as gtp_main
from p3achygo_tpu_torch.gtp.analysis import extract_pv
from p3achygo_tpu_torch.gtp.time_control import TimeControl
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.sgf import extract_moves, parse_sgf, serialize_game
from p3achygo_tpu_torch.train.checkpoint import save_checkpoint
from torch_parity import tiny_pair

torch.set_num_threads(2)

SEARCH = dict(n=8, k=4, noise_scale=0.0, tau=0.0, max_depth=6)


def _services(j_eval, t_eval):
    return (jgtp.GtpService(j_eval, jgtp.GtpConfig(search=jg.SearchParams(**SEARCH))),
            tgtp.GtpService(t_eval, tgtp.GtpConfig(search=tg.SearchParams(**SEARCH)),
                            device="cpu"))


@pytest.fixture(scope="module")
def uniform_pair():
    return _services(jg.uniform_eval_fn, tg.uniform_eval_fn)


@pytest.fixture(scope="module")
def tiny_services():
    jm, jvars, tm = tiny_pair(11)
    return _services(jg.make_eval_fn(jm, jvars), tg.make_eval_fn(tm))


def _same(a: str, b: str) -> bool:
    """Responses equal, except that a number after `winrate` or `prior`
    may differ by 1."""
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for i, (x, y) in enumerate(zip(ta, tb)):
        if x != y and not (i > 0 and ta[i - 1] in ("winrate", "prior")
                           and abs(int(x) - int(y)) <= 1):
            return False
    return True


def _sgf(tmp_path) -> str:
    path = os.path.join(tmp_path, "game.sgf")
    with open(path, "w") as f:
        f.write(serialize_game([(1, 72), (-1, 288), (1, 60), (-1, 300), (1, 61)]))
    return path


def _script(tmp_path):
    sgf = _sgf(tmp_path)
    return [
        "protocol_version", "name", "version", "known_command genmove",
        "known_command frobnicate", "list_commands", "boardsize 19", "boardsize 9",
        "frobnicate", "7 name", "clear_board", "komi 6.5", "play b D4",
        "genmove w", "play b D4", "undo", "genmove w", "play b Q16", "genmove w",
        "genmove b", "lz-analyze", "p3achygo-ownership", "final_score", "showboard",
        f"loadsgf {sgf} 4", "genmove b", "lz-analyze b", "showboard", "undo",
        "undo", "genmove w", "play w pass", "genmove b", "final_score",
    ]


def _run_script(pair, tmp_path):
    js, ts = pair
    for svc in pair:
        svc.handle("clear_board")
    for cmd in _script(tmp_path):
        a, b = js.handle(cmd), ts.handle(cmd)
        assert a[0] == b[0] and _same(a[1], b[1]), (cmd, a, b)
    # The carried trees and the SGF with trees agree (comments hold floats
    # printed to 6 places; their counts and the moves must agree).
    paths = [os.path.join(tmp_path, f"{n}.sgf") for n in ("jax", "port")]
    for svc, path in zip(pair, paths):
        ok, resp = svc.handle(f"p3achygo-serialize_sgf_with_trees {path}")
        assert ok and resp == path
    texts = [open(p).read() for p in paths]
    strip = lambda t: re.sub(r"C\[[^\]]*\]", "", t)
    assert strip(texts[0]) == strip(texts[1])
    assert re.findall(r"N: (\d+)", texts[0]) == re.findall(r"N: (\d+)", texts[1])
    moves = ts._moves
    assert moves == js._moves and len(moves) > 4
    assert extract_moves(parse_sgf(texts[1]))[:len(moves)] == moves


def test_vertices_and_colors():
    for a in range(-1, 363):
        v = jgtp.action_to_gtp_vertex(a)
        assert tgtp.action_to_gtp_vertex(a) == v
        if 0 <= a <= 361:
            assert tgtp.gtp_vertex_to_action(v) == jgtp.gtp_vertex_to_action(v) == a
    from p3achygo_tpu.gtp.service import parse_color as jax_parse_color
    from p3achygo_tpu_torch.gtp.service import parse_color
    for c in ("b", "B", "black", "w", "White"):
        assert parse_color(c) == jax_parse_color(c)
    with pytest.raises(ValueError):
        parse_color("red")


def test_service_runs_on_the_card_by_default():
    import inspect

    assert inspect.signature(tgtp.GtpService).parameters["device"].default == "cuda"


def test_time_control_budget_math():
    """The cases of tests/test_gtp.py's budget test and more, on both."""
    def run(tc_cls):
        out = []
        tc = tc_cls()
        out.append(tc.compute_move_time_ms(0))  # unconfigured
        tc.set_time_settings(300, 0, 0)
        out += [tc.compute_move_time_ms(m) for m in (0, 100, 395)]
        out += [tc.compute_move_time_ms(100, v) for v in (0.0, 0.5, -0.9, 1.5)]
        out.append(tc.compute_move_time_ms(100, 0.3, root_stddev=0.2))
        tc.observe_search(120.0, 16, root_stddev=0.1)
        tc.observe_search(300.0, 64, root_stddev=0.4)
        out += [tc.ms_per_visit, tc.stddev_ema]
        out.append(tc.compute_move_time_ms(100, 0.3, root_stddev=0.2))
        tc.set_time_left(0, 10, 3)  # byoyomi: move at the last second
        out.append(tc.compute_move_time_ms(100))
        tc2 = tc_cls()
        tc2.ms_per_visit = 10.0
        out += [tc2.pick_visits(700, (16, 32, 64, 128)), tc2.pick_visits(50, (16, 32, 64)),
                tc2.pick_visits(0), tc2.pick_visits(5000)]
        return out
    assert run(TimeControl) == run(JaxTimeControl)
    assert run(TimeControl)[-5] == 9000


def test_command_script_uniform(uniform_pair, tmp_path):
    _run_script(uniform_pair, str(tmp_path))


def test_command_script_tiny_model(tiny_services, tmp_path):
    _run_script(tiny_services, str(tmp_path))


def test_timed_search_slice_sequence(uniform_pair):
    """Under the same fake clock both services run the same slices (visit
    counts per slice), stop at the same point and carry the same tree."""
    seqs = []
    for svc in uniform_pair:
        svc.handle("clear_board")
        svc.handle("play b D4")
        svc.time_control = type(svc.time_control)()
        slices = []
        run = svc._run_search

        def counted(n, *args, _run=run, _slices=slices):
            _slices.append(n)
            return _run(n, *args)
        svc._run_search = counted
        t = [0.0]

        def clock():
            t[0] += 0.02  # two reads per slice: 40 ms a slice
            return t[0]
        try:
            res, work = svc._timed_search(svc.state, budget_ms=200, clock=clock)
        finally:
            del svc._run_search
        seqs.append((slices, int(res.visits[0]), int(work.n[0, 0]),
                     int(svc._tree.n[0, 0]), round(svc.time_control.ms_per_visit, 6)))
    assert seqs[0] == seqs[1]
    assert len(seqs[1][0]) > 1  # more than one slice ran and accumulated


def test_stdin_loop_stringio(uniform_pair):
    """Without a file descriptor the REPL answers line by line (no pondering,
    lz-analyze with an interval answers once)."""
    text = ("1 name\nbogus_cmd\n# a comment\n\nclear_board\nplay b Q16\ngenmove w\n"
            "lz-analyze b 10\n2 final_score\nquit\nname\n")
    outs = []
    for svc, loop in zip(uniform_pair, (jgtp.run_stdin_loop, tgtp.run_stdin_loop)):
        out = io.StringIO()
        loop(svc, io.StringIO(text), out)
        outs.append(out.getvalue())
    assert _same(outs[0], outs[1]), outs
    assert "= p3achygo_tpu" in outs[1] and "? unknown command" in outs[1]
    assert outs[1].endswith("=\n\n") and outs[1].count("= info move") == 1


class _Lines:
    """An output file that records each write and wakes a waiting reader."""

    def __init__(self):
        self.text = ""
        self.cv = threading.Condition()

    def write(self, s):
        with self.cv:
            self.text += s
            self.cv.notify_all()

    def flush(self):
        pass

    def wait_for(self, pred, timeout=120.0):
        with self.cv:
            assert self.cv.wait_for(lambda: pred(self.text), timeout), self.text


def _pipe_session(svc, loop):
    """Drive `loop` over an os.pipe: each command is written once the
    previous answer is out and, with pondering on, once the idle ponder
    has reached the visit cap, so the session is deterministic up to the
    streamed lz-analyze (whose first line is). Returns (output, the
    visits each ponder batch reported)."""
    r, w = os.pipe()
    infile = os.fdopen(r, "r")
    out = _Lines()
    capped = threading.Event()
    visits = []
    ponder = svc.ponder_once

    def counted():
        v = ponder()
        visits.append(v)
        if v >= svc.config.ponder_visit_cap:
            capped.set()
        return v
    svc.ponder_once = counted
    old_cfg = svc.config
    svc.config = dataclasses.replace(old_cfg, ponder=True, ponder_visit_cap=24)
    done = threading.Thread(target=loop, args=(svc, infile, out), daemon=True)
    done.start()
    try:
        def send(line, answers):
            capped.wait(120)
            capped.clear()
            os.write(w, line.encode())
            out.wait_for(lambda t: t.count("\n\n") >= answers)
        send("clear_board\n", 1)
        send("genmove b\n", 2)
        send("play w D4\n", 3)
        # Streamed analysis: stop it once its first info line is out.
        capped.wait(120)
        os.write(w, b"lz-analyze b 10\n")
        out.wait_for(lambda t: "info move" in t)
        os.write(w, b"name\n")
        out.wait_for(lambda t: t.count("\n\n") >= 5)
        os.write(w, b"quit\n")
        done.join(120)
        assert not done.is_alive()
    finally:
        os.close(w)
        infile.close()
        del svc.ponder_once
        svc.config = old_cfg
    return out.text, visits


def test_stdin_loop_pipe_ponder_and_stream(uniform_pair):
    """Over a pipe the REPL ponders in idle time, accumulating the carried
    tree to the visit cap, and streams lz-analyze until the next command;
    both services ponder the same batches and stream the same first line."""
    runs = [_pipe_session(svc, loop)
            for svc, loop in zip(uniform_pair, (jgtp.run_stdin_loop, tgtp.run_stdin_loop))]
    (jt, jv), (tt, tv) = runs
    assert tv[:6] == jv[:6] and tv[1] > tv[0]  # ponder accumulates visits
    assert max(tv) >= 24
    head = lambda t: t.split("info move", 1)[0]
    first_info = lambda t: "info move" + t.split("info move", 2)[1]
    assert head(tt) == head(jt)
    assert _same(first_info(tt), first_info(jt))
    assert tt.startswith("=\n\n= ") and "= p3achygo_tpu" in tt and tt.endswith("=\n\n")


def test_undo_restores_state_bit_for_bit(uniform_pair):
    svc = uniform_pair[1]
    svc.handle("clear_board")
    for cmd in ("play b D4", "genmove w", "play b Q16"):
        svc.handle(cmd)
    before = GoState(*[t.clone() for t in svc.state])
    for cmd in ("genmove w", "undo", "play w C3", "undo", "play b E5", "undo"):
        ok, _ = svc.handle(cmd)
        assert ok, cmd
    for f, a, b in zip(GoState._fields, before, svc.state):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert svc.state.to_move.shape == (1,) and svc.state.to_move.dtype == torch.int8
    # A PV walks the carried tree after a few ponder batches.
    for _ in range(3):
        svc.ponder_once()
    top = int(svc._tree.edge_n[0, 0].argmax())
    assert extract_pv(svc._tree, top)[0] == top


def test_main_with_checkpoint(tmp_path, monkeypatch, capsys):
    """The entry point on the CPU with a port checkpoint converted from the
    flax variables answers genmove as the JAX service over the same bf16
    network (the JAX entry point's model) does."""
    from p3achygo_tpu.models import build_model as jax_build
    from p3achygo_tpu.models import get_config as jax_get_config

    jm, jvars, tm = tiny_pair(5)
    ckpt = save_checkpoint(str(tmp_path), 1, {"model": tm.state_dict()}, live=False)
    jm16 = jax_build(jax_get_config("tiny"), dtype=jnp.bfloat16)
    want = jgtp.GtpService(jg.make_eval_fn(jm16, jvars), jgtp.GtpConfig(
        search=jg.SearchParams(n=8, k=4, noise_scale=0.0))).handle("genmove b")
    monkeypatch.setattr(sys, "stdin", io.StringIO("genmove b\nquit\n"))
    gtp_main(["--device", "cpu", "--model", "tiny", "--n", "8", "--k", "4",
              "--checkpoint", ckpt])
    assert capsys.readouterr().out == f"= {want[1]}\n\n=\n\n"
    assert want[0]
