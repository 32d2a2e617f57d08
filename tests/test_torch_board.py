"""Rules engine of the PyTorch port held against the JAX package: random
legal play stepped in lockstep, exact on every integer field."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p3achygo_tpu.constants as jconst
from p3achygo_tpu.game import board as jb
from p3achygo_tpu.game import symmetry as jsym
from p3achygo_tpu_torch import constants as tconst
from p3achygo_tpu_torch.game import board as tb
from p3achygo_tpu_torch.game import symmetry as tsym
from torch_parity import random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

_jstep = jax.jit(jax.vmap(jb.step))
_jlegal = jax.jit(jax.vmap(jb.legal_mask))
_jsuperko = jax.jit(jax.vmap(jb.superko_violation))
_jchains = jax.jit(jax.vmap(jb.compute_chains))


def P(i, j):
    return i * 19 + j


def assert_states_equal(js, ts, msg=""):
    for f in tb.GoState._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), to_np(getattr(js, f)),
                                      err_msg=f"{f} {msg}")


def test_constants_match_jax_package():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


def test_tables_match_jax_package():
    np.testing.assert_array_equal(tb.ZOBRIST.on("cpu").numpy(),
                                  np.asarray(jb.ZOBRIST).astype(np.int64))
    np.testing.assert_array_equal(tb.NEIGHBORS.on("cpu").numpy(),
                                  np.asarray(jb.NEIGHBORS))
    np.testing.assert_array_equal(tsym.SYM_GATHER.on("cpu").numpy(),
                                  np.asarray(jsym.SYM_GATHER))
    np.testing.assert_array_equal(tsym.SYM_SCATTER.on("cpu").numpy(),
                                  np.asarray(jsym.SYM_SCATTER))


def test_new_state_matches():
    js = jax.vmap(lambda _: jb.new_state(6.5))(jnp.arange(3))
    assert_states_equal(js, tb.new_state(3, 6.5))


@pytest.mark.parametrize("seed", [0, 1])
def test_lockstep_random_play(seed):
    """~60 plies at B=8 with some passes: every field, the legal mask, the
    move status and superko checks agree exactly after every ply."""
    B = 8
    rng = np.random.default_rng(seed)
    js = jax.vmap(lambda _: jb.new_state())(jnp.arange(B))
    ts = tb.new_state(B)
    for ply in range(60):
        jm = np.asarray(_jlegal(js))
        tm = tb.legal_mask_batch(ts).numpy()
        np.testing.assert_array_equal(tm, jm, err_msg=f"legal ply {ply}")
        acts = np.array([rng.choice(np.flatnonzero(m[:361]))
                         if rng.random() > 0.05 else 361 for m in jm], np.int32)
        # occasionally try an occupied / illegal point to exercise statuses
        if ply % 7 == 3:
            acts[0] = int(np.flatnonzero(~jm[0][:361])[0])
        probe = rng.integers(0, 362, size=B).astype(np.int32)
        np.testing.assert_array_equal(
            tb.superko_violation(ts, torch.from_numpy(probe)).numpy(),
            np.asarray(_jsuperko(js, jnp.asarray(probe))))
        js, jstat = _jstep(js, jnp.asarray(acts))
        ts, tstat = tb.step(ts, torch.from_numpy(acts))
        np.testing.assert_array_equal(tstat.numpy(), np.asarray(jstat))
        assert_states_equal(js, ts, f"ply {ply}")
    np.testing.assert_array_equal(tb.is_game_over(ts).numpy(),
                                  np.asarray(jax.vmap(jb.is_game_over)(js)))


def test_positional_superko_after_ko_and_passes():
    """Black takes a ko, both pass, white's retake repeats a position."""
    seq = [P(1, 0), P(0, 2), P(0, 1), P(2, 2), P(2, 1), P(1, 3), P(10, 10),
           P(1, 1), P(1, 2), 361, 361]
    js = jax.vmap(lambda _: jb.new_state())(jnp.arange(1))
    ts = tb.new_state(1)
    for m in seq:
        a = np.array([m], np.int32)
        js, _ = _jstep(js, jnp.asarray(a))
        ts, _ = tb.step(ts, torch.from_numpy(a))
    retake = np.array([P(1, 1)], np.int32)
    assert bool(np.asarray(_jsuperko(js, jnp.asarray(retake)))[0])
    assert bool(tb.superko_violation(ts, torch.from_numpy(retake))[0])
    js2, jstat = _jstep(js, jnp.asarray(retake))
    ts2, tstat = tb.step(ts, torch.from_numpy(retake))
    assert int(tstat[0]) == tb.MOVE_REPEATED_POSITION == int(jstat[0])
    assert_states_equal(js2, ts2)


def test_simple_ko_point_and_prisoners():
    seq = [P(1, 0), P(0, 2), P(0, 1), P(2, 2), P(2, 1), P(1, 3), P(10, 10),
           P(1, 1), P(1, 2)]
    js = jax.vmap(lambda _: jb.new_state())(jnp.arange(1))
    ts = tb.new_state(1)
    for m in seq:
        a = np.array([m], np.int32)
        js, _ = _jstep(js, jnp.asarray(a))
        ts, _ = tb.step(ts, torch.from_numpy(a))
    assert int(ts.ko_point[0]) == P(1, 1)
    assert int(ts.num_w_prisoners[0]) == 1
    assert not bool(tb.legal_mask_batch(ts)[0, P(1, 1)])
    assert_states_equal(js, ts)


@pytest.mark.parametrize("moves", [20, 80])
def test_compute_chains_and_hash(moves):
    js = random_jax_states(B=6, moves=moves, seed=moves)
    ts = state_to_torch(js)
    np.testing.assert_array_equal(tb.compute_chains(ts.stones).numpy(),
                                  np.asarray(_jchains(js.stones)))
    np.testing.assert_array_equal(
        tb.compute_hash(ts.stones).numpy(),
        to_np(jax.vmap(jb.compute_hash)(js.stones)))
    np.testing.assert_array_equal(
        tb.point_liberties(ts.stones, ts.chain_id).numpy(),
        np.asarray(jax.vmap(jb.point_liberties)(js.stones, js.chain_id)))


def test_symmetry_functions():
    rng = np.random.default_rng(3)
    grid = rng.integers(-1, 2, size=(8, 361)).astype(np.int8)
    sym = np.arange(8, dtype=np.int32)
    np.testing.assert_array_equal(
        tsym.apply_symmetry_grid_batch(torch.from_numpy(grid),
                                       torch.from_numpy(sym)).numpy(),
        np.asarray(jsym.apply_symmetry_grid_batch(jnp.asarray(grid),
                                                  jnp.asarray(sym))))
    acts = rng.integers(-1, 362, size=(8, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tsym.apply_symmetry_action(torch.from_numpy(acts),
                                   torch.from_numpy(sym)).numpy(),
        np.asarray(jax.vmap(jsym.apply_symmetry_action)(jnp.asarray(acts),
                                                        jnp.asarray(sym))))
