"""The port's host-side self-play support held against the JAX package
under the same numpy seeds: the opening book's prefixes, the GoExploit,
regret-guided and composite reuse buffers, fork plans and the trapezoidal
fork-move draw, regret candidates, and the ForkManager's host paths
(uniform and regret forks, which need no network). Every sequence must be
equal, element by element."""
import dataclasses

import numpy as np
import pytest

from p3achygo_tpu.selfplay import book as jbook
from p3achygo_tpu.selfplay import fork as jfork
from p3achygo_tpu.selfplay import reuse as jreuse
from p3achygo_tpu_torch.selfplay import book as tbook
from p3achygo_tpu_torch.selfplay import fork as tfork
from p3achygo_tpu_torch.selfplay import reuse as treuse


def _same_state(a, b):
    """Two InitStates (of either package) are equal field by field."""
    assert (a is None) == (b is None)
    if a is None:
        return
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_book_matches_jax():
    assert tbook.OPENING_BOOK == jbook.OPENING_BOOK
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(300):
        assert tbook.sample_book_prefix(rt) == jbook.sample_book_prefix(rj)


def test_fmb_constants_match_jax():
    assert (treuse.FMB_SAMPLE, treuse.FMB_PLAY, treuse.FMB_FORCE_FULL_SEARCH) == \
        (jreuse.FMB_SAMPLE, jreuse.FMB_PLAY, jreuse.FMB_FORCE_FULL_SEARCH)


def _state(mod, rng, i):
    return mod.InitState(stones=rng.integers(-1, 2, 361).astype(np.int8),
                         last_moves=rng.integers(-1, 362, 5).astype(np.int16),
                         to_move=int(rng.choice([1, -1])), move_num=i,
                         komi=float(rng.choice([6.5, 7.5])),
                         first_move_behavior=int(rng.integers(3)))


@pytest.mark.parametrize("kind", ["goexploit", "regret", "composite"])
def test_reuse_buffers_match_jax(kind):
    """The same adds (states, regrets, games) and the same gets give the
    same sequence of states, with eviction past a small capacity."""
    bj = jreuse.make_reuse_buffer(kind, capacity=16, seed=3)
    bt = treuse.make_reuse_buffer(kind, capacity=16, seed=3)
    rng = np.random.default_rng(9)
    for i in range(40):
        op = rng.integers(4)
        seed = int(rng.integers(1 << 30))
        if op <= 1:
            regret = float(rng.uniform(0, 3))
            bj.add(_state(jreuse, np.random.default_rng(seed), i), regret)
            bt.add(_state(treuse, np.random.default_rng(seed), i), regret)
        elif op == 2:
            g = np.random.default_rng(seed)
            L = int(g.integers(1, 60))
            args = (g.integers(-1, 2, (L, 361)).astype(np.int8),
                    g.integers(-1, 362, (L, 5)).astype(np.int16),
                    np.where(np.arange(L) % 2 == 0, 1, -1).astype(np.int8), L)
            bj.maybe_add_from_game(*args, add_prob=0.2)
            bt.maybe_add_from_game(*args, add_prob=0.2)
        else:
            _same_state(bj.get(), bt.get())
        assert len(bj) == len(bt)
    while len(bj):
        _same_state(bj.get(), bt.get())
    assert len(bt) == 0 and bt.get() is None


def test_fork_plans_and_moves_match_jax():
    for params in (jfork.ForkParams(), jfork.ForkParams.for_reuse(0.25),
                   jfork.ForkParams.for_reuse(0.01),
                   dataclasses.replace(jfork.ForkParams(), regret_prob=0.3, early_fork_prob=0.2,
                                       sample_policy_t1_prob=0.1, sample_policy_t2_prob=0.1)):
        tparams = tfork.ForkParams(**dataclasses.asdict(params))
        assert tparams.uniform_prob == params.uniform_prob
        rj, rt = np.random.default_rng(1), np.random.default_rng(1)
        for _ in range(400):
            assert dataclasses.asdict(tfork.sample_fork_plan(rt, tparams)) == \
                dataclasses.asdict(jfork.sample_fork_plan(rj, params))
    assert tfork.ForkParams.for_reuse(0.1) == tfork.ForkParams(
        **dataclasses.asdict(jfork.ForkParams.for_reuse(0.1)))
    rj, rt = np.random.default_rng(2), np.random.default_rng(2)
    assert [tfork.sample_trapezoidal(rt) for _ in range(300)] == \
        [jfork.sample_trapezoidal(rj) for _ in range(300)]


def _record(mod, seed, L=40, init_mv=0):
    rng = np.random.default_rng(seed)
    return mod.GameRecord(
        stones=rng.integers(-1, 2, size=(L, 361)).astype(np.int8),
        last_moves=rng.integers(0, 361, size=(L, 5)).astype(np.int16),
        to_move=np.array([1 if t % 2 == 0 else -1 for t in range(L)], np.int8),
        move=rng.integers(0, 361, size=(L,)).astype(np.int16),
        nn_value=rng.uniform(-0.95, 0.95, L).astype(np.float32),
        mcts_value=rng.uniform(-0.95, 0.95, L).astype(np.float32),
        mcts_score=rng.uniform(-10, 10, L).astype(np.float32),
        eligible=rng.random(L) < 0.8, komi=7.5, winner=int(rng.choice([1, -1])),
        init_mv_num=init_mv)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_regret_candidates_and_komi_delta_match_jax(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    got = tfork.regret_candidates(_record(tfork, seed, init_mv=30 * seed), rt)
    want = jfork.regret_candidates(_record(jfork, seed, init_mv=30 * seed), rj)
    assert got == want and got
    for score in (-7.4, -0.5, 0.0, 0.5, 3.6):
        for color in (1, -1):
            assert tfork.compute_komi_delta(score, color) == jfork.compute_komi_delta(score, color)


@pytest.mark.parametrize("kind", ["uniform", "regret"])
def test_fork_manager_host_paths_match_jax(kind):
    """process_game for plans that need no network adds the same states
    to the same buffer kind, in the same order, with the same counts."""
    buf_kind = "goexploit" if kind == "uniform" else "regret"
    bj = jreuse.make_reuse_buffer(buf_kind, seed=4)
    bt = treuse.make_reuse_buffer(buf_kind, seed=4)
    mj = jfork.ForkManager(jfork.ForkParams(), bj, evaluator=None, seed=6)
    mt = tfork.ForkManager(tfork.ForkParams(), bt, evaluator=None, seed=6)
    for g in range(12):
        plan = (kind, -1)
        mj.process_game(jfork.ForkPlan(*plan), _record(jfork, 100 + g, L=30 + g))
        mt.process_game(tfork.ForkPlan(*plan), _record(tfork, 100 + g, L=30 + g))
        assert mt.counts == mj.counts
    assert len(bt) == len(bj) > 0
    while len(bj):
        _same_state(bj.get(), bt.get())
    assert mt._jobs == [] and mt.new_plan(False) is None
