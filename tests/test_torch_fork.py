"""The port's fork evaluator and fork flush (p3achygo_tpu_torch/selfplay/
fork.py) held against the JAX package with the same `tiny` float32
weights: legality exact, probabilities and values to 1e-5 and scores to
1e-5 + 1e-6 of their size (a score is a sum over 800 bins of values up to
+-400, so float32 summation order moves it by an ulp or two), the
positions after a move exact; and a flush of staged fork jobs (every
network-driven kind) adds the same states to the reuse buffer, in the
same order, as the JAX flush under the same numpy seed. The port
evaluates exactly the n positions, in chunks of `batch` (4 here: the
chunking must not change a result); the JAX evaluator pads to 64."""
import dataclasses

import numpy as np
import pytest
import torch

from p3achygo_tpu.selfplay import fork as jfork
from p3achygo_tpu.selfplay import reuse as jreuse
from p3achygo_tpu_torch.selfplay import fork as tfork
from p3achygo_tpu_torch.selfplay import reuse as treuse
from torch_parity import random_jax_states, tiny_pair

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(scope="module")
def nets():
    jm, jvars, tm = tiny_pair(seed=7)
    return (jfork.ForkEvaluator(model=jm), jvars,
            tfork.ForkEvaluator(batch=4, device="cpu"), tm)


@pytest.fixture(scope="module")
def boards():
    """Played-out boards at 20 to 120 moves."""
    states = [random_jax_states(5, m, seed=m, pass_prob=0.05) for m in (20, 60, 120)]
    return np.concatenate([np.array(s.stones) for s in states])


def _positions(mod, stones, seed):
    rng = np.random.default_rng(seed)
    return [mod._Position(stones=s, last_moves=rng.integers(-1, 362, 5).astype(np.int32),
                          to_move=int(rng.choice([1, -1])),
                          komi=float(rng.choice([-0.5, 7.5, 20.5])))
            for s in stones]


def test_evaluate_and_play_match_jax(nets, boards):
    jev, jvars, tev, tm = nets
    pj, pt = _positions(jfork, boards, 1), _positions(tfork, boards, 1)
    want = jev.evaluate(jvars, pj)
    got = tev.evaluate(tm, pt)
    np.testing.assert_array_equal(got[0], want[0])
    for name, g, w, rtol in zip(("probs", "value", "score"), got[1:], want[1:],
                                (0, 0, 1e-6)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=rtol, atol=TOL, err_msg=name)
    assert got[3].std() > 0.1  # scores vary: the comparison means something
    rng = np.random.default_rng(2)
    moves = [int(rng.choice(np.flatnonzero(m))) for m in want[0]]
    for a, b in zip(tev.play(pt, moves), jev.play(pj, moves)):
        np.testing.assert_array_equal(a.stones, b.stones)
        np.testing.assert_array_equal(a.last_moves, b.last_moves)
        assert (a.to_move, a.komi) == (b.to_move, b.komi)
    empty = tev.evaluate(tm, [])
    assert empty[0].shape == (0, 362) and tev.play([], []) == []


def _record(mod, stones, seed):
    L = stones.shape[0]
    rng = np.random.default_rng(seed)
    return mod.GameRecord(
        stones=stones, last_moves=rng.integers(0, 361, (L, 5)).astype(np.int16),
        to_move=np.where(np.arange(L) % 2 == 0, 1, -1).astype(np.int8),
        move=rng.integers(0, 361, L).astype(np.int16),
        nn_value=rng.uniform(-0.5, 0.5, L).astype(np.float32),
        mcts_value=rng.uniform(-0.5, 0.5, L).astype(np.float32),
        mcts_score=rng.uniform(-10, 10, L).astype(np.float32),
        eligible=np.ones(L, bool), komi=7.5, winner=1, init_mv_num=3)


def test_flush_matches_jax(nets, boards):
    """Staged EARLY, LATE, SAMPLE_T1, SAMPLE_T2 and SAMPLE_UNIFORM jobs,
    with double sampling on for half of them, flushed by both packages."""
    jev, jvars, tev, tm = nets
    params = jfork.ForkParams(double_sample_prob=0.5, force_full_search_prob=0.5)
    bj, bt = jreuse.GoExploitBuffer(seed=1), treuse.GoExploitBuffer(seed=1)
    mj = jfork.ForkManager(params, bj, jev, seed=3)
    mt = tfork.ForkManager(tfork.ForkParams(**dataclasses.asdict(params)), bt, tev, seed=3)
    kinds = (jfork.EARLY, jfork.LATE, jfork.SAMPLE_T1, jfork.SAMPLE_T2, jfork.SAMPLE_UNIFORM)
    for g, kind in enumerate(kinds * 2):
        m = (3 * g) % boards.shape[0]
        mj.process_game(jfork.ForkPlan(kind, m), _record(jfork, boards, g))
        mt.process_game(tfork.ForkPlan(kind, m), _record(tfork, boards, g))
    assert len(mt._jobs) == len(mj._jobs) == 10
    assert mt.flush(tm) == mj.flush(jvars) == 10
    assert mt.counts == mj.counts and len(bt) == len(bj) == 10
    for a, b in zip(bt._buf, bj._buf):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    assert {s.first_move_behavior for s in bt._buf} >= {treuse.FMB_PLAY,
                                                       treuse.FMB_FORCE_FULL_SEARCH}
    assert mt.flush(tm) == 0
