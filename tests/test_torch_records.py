"""The port's game records and replay buffer (p3achygo_tpu_torch/selfplay/
records.py, data/replay.py: numpy copies of the JAX package's modules)
held against the JAX package: finalize_game on the buffers of a JAX
self-play run, the TD-target helpers, and ReplayBuffer add / sample /
window / save / load under one seed."""
import jax
import numpy as np
import pytest

from p3achygo_tpu.data import replay as jr
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu.selfplay import records as jrec
from p3achygo_tpu_torch.data import replay as tr
from p3achygo_tpu_torch.selfplay import records as trec
from torch_parity import jax_selfplay_games

B, T = 4, 12
FIELDS = ("stones", "last_moves", "to_move", "pi", "move", "root_q_outcome",
          "root_score", "kld", "trainable", "mcts_value_dist")
INT_FIELDS = ("stones", "last_moves", "color", "pi_aux", "has_pi_aux_dist", "own",
              "mcts_value_dist")


@pytest.fixture(scope="module")
def games():
    """B finished (or capped) JAX self-play games, every move trainable."""
    states, buf = jax_selfplay_games(B, T, T + 1)
    bs, ws, own = jax.jit(jl.final_scores)(states)
    buf = jax.tree_util.tree_map(np.asarray, buf)
    return [dict({f: getattr(buf, f)[b] for f in FIELDS},
                 num_moves=min(int(states.move_count[b]), T),
                 black_score=float(bs[b]), white_score=float(ws[b]),
                 ownership=np.asarray(own[b]), komi=7.5) for b in range(B)]


def _assert_examples_equal(got, want):
    for f in want.__dataclass_fields__:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f in INT_FIELDS:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=f)


def test_finalize_game(games):
    assert any(np.any(g["root_q_outcome"] != 0) for g in games)
    for g in games:
        want = jrec.finalize_game(**g)
        got = trec.finalize_game(**g)
        assert want is not None and len(want) == int(g["trainable"][:g["num_moves"]].sum())
        _assert_examples_equal(got, want)
        for lam, hor in ((5 / 6, 6), (15 / 16, 16), (49 / 50, None)):
            vals = g["root_q_outcome"][:g["num_moves"]].astype(np.float64)
            np.testing.assert_allclose(trec._exp_weighted_all(vals, lam, hor),
                                       jrec._exp_weighted_all(vals, lam, hor),
                                       rtol=0, atol=1e-12)


def test_finalize_game_edge_cases(games):
    g = dict(games[0])
    assert trec.finalize_game(**dict(g, num_moves=0)) is None
    assert trec.finalize_game(**dict(g, trainable=np.zeros(T, bool))) is None
    # No kld signal: weights stay 1.
    _assert_examples_equal(trec.finalize_game(**dict(g, kld=np.zeros(T, np.float32))),
                           jrec.finalize_game(**dict(g, kld=np.zeros(T, np.float32))))


@pytest.mark.parametrize("lam,hor", [(5 / 6, 6), (15 / 16, 16), (49 / 50, None)])
def test_exp_weighted_all(lam, hor):
    rng = np.random.default_rng(0)
    for n in (1, 5, 37):
        vals = rng.normal(size=n)
        got = trec._exp_weighted_all(vals, lam, hor)
        np.testing.assert_allclose(got, jrec._exp_weighted_all(vals, lam, hor),
                                   rtol=0, atol=1e-12)
        for t in range(n):
            h = n - t - 1 if hor is None else min(hor, n - t - 1)
            assert abs(got[t] - trec._exp_weighted(vals, t, lam, h)) < 1e-9


def test_replay_buffer(games, tmp_path):
    exs = [trec.finalize_game(**g) for g in games]
    jbuf, tbuf = jr.ReplayBuffer(capacity=40, seed=5), tr.ReplayBuffer(capacity=40, seed=5)
    for _ in range(3):  # wraps the ring
        for ex in exs:
            jbuf.add_game(ex)
            tbuf.add_game(ex)
    assert (len(tbuf), tbuf.total_added, tbuf.games_added) == \
        (len(jbuf), jbuf.total_added, jbuf.games_added)
    assert tbuf.training_window() == jbuf.training_window()
    for window in (None, 7):
        a, b = jbuf.sample(16, window), tbuf.sample(16, window)
        for f in a:
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    tbuf.save(str(tmp_path / "replay.npz"))
    jbuf.save(str(tmp_path / "jreplay.npz"))
    t2, j2 = tr.ReplayBuffer(capacity=64, seed=9), jr.ReplayBuffer(capacity=64, seed=9)
    t2.load(str(tmp_path / "replay.npz"))
    j2.load(str(tmp_path / "jreplay.npz"))
    a, b = j2.sample(8), t2.sample(8)
    for f in a:
        np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    with pytest.raises(ValueError):
        tr.ReplayBuffer(capacity=4).sample(1)
