"""The port's SL pipeline (data/sl.py) held against the JAX package's:
the same SGF gives the same examples, field by field, whether the port
replays it alone or in a lockstep batch beside longer, shorter and corrupt
games; the shard writer's workers write exactly those examples."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from p3achygo_tpu.data import sl as jsl
from p3achygo_tpu_torch.data import sl as tsl
from p3achygo_tpu_torch.data.export import examples_to_records
from p3achygo_tpu_torch.data.replay import ReplayBuffer
from p3achygo_tpu_torch.data.tfrecord import read_records
from p3achygo_tpu_torch.game.board import legal_mask_batch, new_state, step
from p3achygo_tpu_torch.selfplay.records import GameExamples
from p3achygo_tpu_torch.sgf import serialize_game
from test_sl import _make_sgf

torch.set_num_threads(2)


def _random_game_sgf(seed: int, moves: int = 40, result="W+3.5") -> str:
    """An SGF of `moves` plies of seeded random legal play (passes now and
    then, so colours repeat after a pass)."""
    rng = np.random.default_rng(seed)
    st = new_state(1, device="cpu")
    played = []
    for _ in range(moves):
        legal = np.flatnonzero(legal_mask_batch(st)[0, :361].numpy())
        a = 361 if rng.random() < 0.05 else int(rng.choice(legal))
        played.append((int(st.to_move[0]), a))
        st, _ = step(st, torch.tensor([a]))
    return serialize_game(played, komi=6.5, result=result)


CORRUPT = _make_sgf().replace(";W[pp]", ";W[dd]")  # white plays on black's stone


def _assert_same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for f in dataclasses.fields(GameExamples):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_result_parsing_matches_jax():
    for r in ("B+3.5", "W+R", "w+12", "0", "B+Resign", "W+T", "B+", "Draw", "B+x"):
        assert tsl._result_to_z_margin(r) == jsl._result_to_z_margin(r), r


@pytest.fixture(scope="module")
def sgfs():
    return [_random_game_sgf(7), _make_sgf(), _make_sgf("W+R", 5), CORRUPT,
            _make_sgf("B+0.5", 1), _make_sgf("W+2.5", 7)]


@pytest.fixture(scope="module")
def jax_examples(sgfs):
    return [jsl.sgf_to_examples(t) for t in sgfs]


def test_sgf_to_examples_matches_jax(sgfs, jax_examples):
    assert jax_examples[3] is None and jax_examples[4] is None
    assert len(jax_examples[0]) == 40
    for text, want in zip(sgfs, jax_examples):
        _assert_same(tsl.sgf_to_examples(text, device="cpu"), want)
    _assert_same(tsl.sgf_to_examples(sgfs[0], max_moves=9, device="cpu"),
                 jsl.sgf_to_examples(sgfs[0], max_moves=9))


def test_lockstep_replay_matches_jax(sgfs, jax_examples):
    games = [tsl.parse_game(t) for t in sgfs]
    assert games[4] is None  # one move: rejected before the replay
    usable = [g for g in games if g is not None]
    got = tsl.replay_games(usable, device="cpu")
    for ex, want in zip(got, [w for g, w in zip(games, jax_examples) if g is not None]):
        _assert_same(ex, want)


def test_build_sl_shards_two_workers(sgfs, jax_examples, tmp_path):
    """2 spawn workers on the CPU; shards, report and `.done` marker; the
    shards hold exactly the records of the usable games' examples."""
    sgf_dir = tmp_path / "sgfs"
    sgf_dir.mkdir()
    for i, text in enumerate(sgfs):
        (sgf_dir / f"g{i}.sgf").write_text(text)
    (sgf_dir / "bad.sgf").write_text("(;GM[1]SZ[x]")  # does not parse
    out_dir = str(tmp_path / "out")
    rep = tsl.build_sl_shards(str(sgf_dir), out_dir, num_workers=2,
                              examples_per_shard=12, device="cpu")
    want = [w for w in jax_examples if w is not None]
    n_ex = sum(len(w) for w in want)
    assert (rep["files"], rep["games"], rep["examples"], rep["errors"], rep["workers"]) \
        == (7, len(want), n_ex, 3, 2)
    assert json.load(open(os.path.join(out_dir, "sl_shards.done"))) == rep
    got = sorted(r for name in rep["shards"]
                 for r in read_records(os.path.join(out_dir, name)))
    assert got == sorted(r for w in want for r in examples_to_records(w, device="cpu"))
    assert all(name.startswith("sl_shard_") and name.endswith(".tfrecord.zz")
               for name in rep["shards"])


def test_build_sl_replay(sgfs, tmp_path):
    for i, text in enumerate(sgfs):
        (tmp_path / f"g{i}.sgf").write_text(text)
    replay = ReplayBuffer(capacity=1024)
    assert tsl.build_sl_replay(str(tmp_path), replay, device="cpu") == 4
    assert len(replay) == 40 + 8 + 5 + 7
    assert tsl.build_sl_replay(str(tmp_path), ReplayBuffer(64), limit_games=2,
                               device="cpu") == 2
    batch = replay.sample(8)
    np.testing.assert_allclose(batch["pi"].sum(-1), 1.0)
