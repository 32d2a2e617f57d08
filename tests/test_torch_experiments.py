"""The experiments layer of the PyTorch port (experiments/visits_study.py,
play_games.py, the CLI) held against the JAX package on the same inputs:
the positions decoded from the same examples, a hash-keyed table evaluator
written identically for both, and the JAX Gumbel draws injected into the
port. Boards, moves and best actions exact; KLD statistics to 1e-5
relative (the improved policies are float32 on both sides)."""
import importlib
import io

import jax
import numpy as np
import pytest
import torch

from p3achygo_tpu.constants import BLACK, WHITE
from p3achygo_tpu.experiments import visits_study as jvs
from p3achygo_tpu_torch.experiments import visits_study as tvs
from torch_parity import gumbel_rows, table_evals, to_np

# The packages export the play_games function under the module's name.
jpg = importlib.import_module("p3achygo_tpu.experiments.play_games")
tpg = importlib.import_module("p3achygo_tpu_torch.experiments.play_games")

torch.set_num_threads(2)

KLD_RTOL = 1e-5


def _fake_examples(n, seed=0):
    """Decoded-example dicts (data/example.py schema subset): a few stones
    of each colour, last moves among them, both colours to move."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        stones = np.zeros((361,), np.int8)
        pts = rng.choice(361, size=8, replace=False)
        stones[pts[:4]] = BLACK
        stones[pts[4:]] = WHITE
        last = np.full((5,), -1, np.int16)
        last[2:] = pts[5:8]
        out.append({
            "board": stones.tobytes(),
            "last_moves": last.tobytes(),
            "color": np.int8(BLACK if i % 2 == 0 else WHITE).tobytes(),
            "komi": [7.5 if i % 3 else -0.5],
        })
    return out


def test_states_from_examples_match_jax():
    exs = _fake_examples(5)
    js = jvs.states_from_examples(exs)
    ts = tvs.states_from_examples(exs, device="cpu")
    for f in ("stones", "chain_id", "hash", "history", "history_len", "last_moves",
              "to_move", "komi", "ko_point", "move_count"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), to_np(getattr(js, f)),
                                      err_msg=f)


def test_kld_stats_and_report_match_jax():
    rng = np.random.default_rng(3)
    t = rng.dirichlet(np.full(362, 0.3), size=7)
    t[:, :40] = 0.0
    t /= t.sum(-1, keepdims=True)
    p = rng.dirichlet(np.full(362, 0.5), size=7).astype(np.float32)
    np.testing.assert_array_equal(tvs.compute_kld(t, p), jvs.compute_kld(t, p))
    np.testing.assert_array_equal(tvs.compute_kld(p, p), jvs.compute_kld(p, p))
    for vals in (rng.exponential(size=13), np.array([]), np.array([2.5])):
        assert tvs._stats(vals) == jvs._stats(vals)
    np.testing.assert_array_equal(tvs._empirical_dist(t * 7), jvs._empirical_dist(t * 7))
    report = {"mode": "gumbel", "gt_n": 64, "k": 4, "seed_visits": 6, "examples": 7,
              "prior": tvs._stats(rng.exponential(size=7)),
              "per_n": [{"n": n, "kld_gt": tvs._stats(rng.exponential(size=7)),
                         "kld_prior": tvs._stats(rng.exponential(size=7)),
                         "nats_per_visit": 0.01 * n} for n in (8, 16)]}
    assert tvs.format_report(report) == jvs.format_report(report)
    puct = dict(report, mode="puct")
    assert tvs.format_report(puct) == jvs.format_report(puct)


def _assert_stats_close(a, b, what):
    for q in ("mean", "p75", "p95", "max"):
        np.testing.assert_allclose(a[q], b[q], rtol=KLD_RTOL, err_msg=f"{what} {q}")


@pytest.mark.parametrize("use_gumbel", [True, False])
def test_visits_study_matches_jax(use_gumbel, monkeypatch):
    """Gumbel mode with a PUCT seeding pass, and PUCT mode (the bias
    branch, a table argument here, is held by test_torch_bias.py). JAX's
    study calls its searches eagerly; they are jitted here, with the same
    arguments, to bound compile time."""
    monkeypatch.setattr(jvs, "search_root", jax.jit(
        jvs.search_root, static_argnames=("eval_fn", "params", "reuse_capacity")))
    monkeypatch.setattr(jvs, "search_root_puct", jax.jit(
        jvs.search_root_puct, static_argnames=("eval_fn", "p", "return_tree")))
    exs = _fake_examples(4, seed=1)
    jax_eval, torch_eval = table_evals(11)
    kw = dict(n_values=(8,), gt_n=16, k=2, seed_visits=4 if use_gumbel else 0,
              use_gumbel=use_gumbel, bias_lambda=0.0, max_depth=4, seed=5)
    jrep = jvs.run_visits_study(jax_eval, jvs.states_from_examples(exs), **kw)
    # JAX's key use: key_pos = split(PRNGKey(seed))[0]; search_root splits
    # key_pos once more and draws its root noise from the second half.
    key_pos, _ = jax.random.split(jax.random.PRNGKey(5))
    noise = gumbel_rows(jax.random.split(key_pos)[1], len(exs))
    trep = tvs.run_visits_study(torch_eval, tvs.states_from_examples(exs, device="cpu"),
                                gumbel_noise=noise, **kw)
    for key in ("examples", "mode", "gt_n", "k", "seed_visits"):
        assert trep[key] == jrep[key], key
    np.testing.assert_array_equal(trep["gt_best"], to_np(jrep["gt_best"]))
    _assert_stats_close(trep["prior"], jrep["prior"], "prior")
    for tr, jr in zip(trep["per_n"], jrep["per_n"]):
        assert tr["n"] == jr["n"]
        np.testing.assert_array_equal(trep["n_best"][tr["n"]], to_np(jrep["n_best"][jr["n"]]))
        _assert_stats_close(tr["kld_gt"], jr["kld_gt"], f"kld_gt n={tr['n']}")
        _assert_stats_close(tr["kld_prior"], jr["kld_prior"], f"kld_prior n={tr['n']}")
    assert "nats/visit" in tvs.format_report(trep)


class _Moves(tpg.Callback):
    """Records (game, move number, move, visits) of every callback."""

    def __init__(self):
        self.rows = []

    def on_move(self, info):
        self.rows.append((info.game_idx, info.move_num, info.move, info.num_visits,
                          int(np.abs(info.position).sum())))


@pytest.mark.parametrize("seq_halving", [True, False])
def test_play_games_matches_jax(seq_halving):
    jax_eval, torch_eval = table_evals(17)
    kw = dict(num_games=2, visit_count=8, seq_halving=seq_halving, k=2, max_depth=4,
              max_moves=12, seed=3)
    jmoves, tmoves = _Moves(), _Moves()
    jout, tout = io.StringIO(), io.StringIO()
    jres = jpg.play_games(jax_eval, callbacks=[jmoves, jpg.BiasCallback(out=jout)], **kw)

    keys = []
    key = jax.random.PRNGKey(3)
    for _ in range(kw["max_moves"]):
        key, ks = jax.random.split(key)
        keys.append(jax.random.split(ks)[1])
    tres = tpg.play_games(torch_eval, callbacks=[tmoves, tpg.BiasCallback(out=tout)],
                          device="cpu", gumbel_noise=lambda m: gumbel_rows(keys[m], 2),
                          **kw)
    assert tmoves.rows == jmoves.rows
    assert [vars(r) for r in tres] == [vars(r) for r in jres]
    assert [str(r) for r in tres] == [str(r) for r in jres]
    for text in (tout.getvalue(), jout.getvalue()):
        assert "Dumping Most Biased Positions for Game" in text
        assert "Dumping Most Biased Positions for Episode" in text


def test_bias_callback_heaps_keep_the_largest():
    out = io.StringIO()
    cb = tpg.BiasCallback(out=out, per_game=2, per_episode=3)
    for m, (nn, mc) in enumerate([(0.1, 0.0), (0.5, -0.5), (0.0, 0.2), (0.9, 0.85)]):
        cb.on_move(tpg.MoveInfo(game_idx=0, move_num=m, color_to_move=BLACK,
                                position=np.zeros(361, np.int8),
                                last_five_moves=np.full(5, -1, np.int32), move=m,
                                nn_eval=nn, mcts_eval=mc, nn_v=0.0, mcts_v=0.0,
                                nn_score=0.0, mcts_score=0.0, num_visits=8))
    cb.on_game_end(tpg.GameResult(0, BLACK, 10.0, 2.5, 4))
    cb.on_episode_end()
    text = out.getvalue()
    game, episode = text.split("Dumping Most Biased Positions for Episode")
    assert "Game Result: B+7.5" in game
    assert [float(x.split()[-1]) for x in game.splitlines() if x.startswith("Bias:")] \
        == pytest.approx([1.0, -0.2])
    assert [float(x.split()[-1]) for x in episode.splitlines() if x.startswith("Bias:")] \
        == pytest.approx([1.0, -0.2, 0.1])


def test_experiments_cli_on_a_chunk(tmp_path, capsys):
    """The CLI on the CPU: visits_study reads a port checkpoint and a
    tfrecord chunk in two batches and prints the pooled report; play_games
    prints each game's result."""
    from p3achygo_tpu_torch.data.example import encode_example
    from p3achygo_tpu_torch.data.tfrecord import write_records
    from p3achygo_tpu_torch.experiments.__main__ import main
    from p3achygo_tpu_torch.models.config import get_config
    from p3achygo_tpu_torch.models.model import build_model, init_params
    from p3achygo_tpu_torch.train.checkpoint import save_named

    model = build_model(get_config("tiny"), torch.bfloat16, "cpu")
    init_params(model, torch.Generator().manual_seed(4))
    ckpt = save_named(str(tmp_path), "model_0001", {"model": model.state_dict()})
    chunk = str(tmp_path / "c.tfrecord.zz")
    write_records(chunk, [encode_example(ex) for ex in _fake_examples(3)])
    assert main(["visits_study", "--model_path", ckpt, "--model_config", "tiny",
                 "--chunk_path", chunk, "--num_examples", "3", "--batch", "2",
                 "--gt_n", "16", "--n_values", "8", "--seed_visits", "4",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Visit Count Study" in out and "Examples:     3" in out
    row = [line for line in out.splitlines() if line.startswith("8 ")]
    assert len(row) == 1 and np.isfinite([float(x) for x in row[0].split()]).all()
    assert main(["play_games", "--model_config", "tiny", "--num_games", "2",
                 "--visit_count", "8", "--seq_halving", "--max_moves", "3",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" in 3 moves") == 2
