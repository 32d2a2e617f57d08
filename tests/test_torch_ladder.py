"""Ladder planes of the PyTorch port held against the JAX package.

The JAX side is one jitted `make_eval_fn(stub, include_ladders=True)` at a
batch of 8, whose stub network hands the planes back to the host, so one
compile serves every case: positions are read under the identity symmetry
(hash lane 0 set to 0), where planes 13 | 14 are `laddered_stones`, and the
textbook ladder under all 8 symmetries. There the state's chain labels are
permuted, not renumbered, and the JAX reader finds no candidate under four
of the symmetries; the port must do the same."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game import board_from_dsl as jax_board_from_dsl
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu_torch.game.dsl import board_from_dsl
from p3achygo_tpu_torch.game.ladder import LADDER_CHUNK, MAX_DEPTH, laddered_stones
from p3achygo_tpu_torch.mcts import gumbel as tg
from torch_parity import random_jax_states, state_to_torch

torch.set_num_threads(2)

B = 8


def _grid(*stones_by_color):
    g = [["." for _ in range(19)] for _ in range(19)]
    for d in stones_by_color:
        for (i, j), ch in d.items():
            g[i][j] = ch
    return "\n".join(" ".join(row) for row in g)


# The six positions of tests/test_ladder.py: (dsl, to_move, point, laddered).
_WALL = {(8, 9): "x", (9, 8): "x", (8, 10): "x"}
POSITIONS = [
    (_grid(_WALL, {(9, 9): "o"}), 1, (9, 9), True),  # working ladder
    (_grid(_WALL, {(9, 9): "o", (15, 15): "o"}), 1, (9, 9), False),  # breaker
    (_grid({(9, 10): "x", (10, 9): "x"}, {(9, 9): "o", (10, 10): "o"}), 1, (9, 9),
     False),  # bare crosscut
    (_grid({(0, 1): "x", (1, 0): "x"}, {(1, 1): "o"}), 1, (1, 1), False),
    (_grid({}, {(5, 5): "o", (5, 6): "o", (6, 5): "o", (6, 6): "o"}), 1, (5, 5),
     False),  # safe group
    (_grid({(0, 1): "x", (1, 1): "x", (2, 0): "x"}, {(0, 0): "o"}), -1, (0, 0),
     True),  # dead atari group
]


def _cat(*states):
    return jax.tree_util.tree_map(lambda *x: jnp.concatenate(x), *states)


def _with_sym(js, syms):
    h = np.asarray(js.hash).copy()
    h[:, 0] = syms
    return js._replace(hash=jnp.asarray(h))


@pytest.fixture(scope="module")
def jax_planes():
    """JAX planes [B, 19, 19, 15] of make_eval_fn(include_ladders=True)."""
    captured = []

    def apply(variables, planes, scalars, train=False, trunk_fn=None):
        jax.debug.callback(lambda p: captured.append(np.asarray(p)), planes)
        n = planes.shape[0]
        return SimpleNamespace(pi_logits=jnp.zeros((n, 362)),
                               outcome_probs=jnp.full((n, 2), 0.5),
                               score_probs=jnp.zeros((n, 800)),
                               q6_err=jnp.zeros((n,)))

    fn = jax.jit(jg.make_eval_fn(SimpleNamespace(apply=apply), None,
                                 include_ladders=True))

    def run(js):
        jax.block_until_ready(fn(js))
        jax.effects_barrier()
        return captured.pop()
    return run


def _torch_planes(ts):
    captured = []

    class Stub:
        dtype = torch.float32

        def __call__(self, planes, scalars, trunk_fn=None):
            captured.append(planes)
            n = planes.shape[0]
            return SimpleNamespace(pi_logits=torch.zeros(n, 362),
                                   outcome_probs=torch.full((n, 2), 0.5),
                                   score_probs=torch.zeros(n, 800),
                                   q6_err=torch.zeros(n))

    tg.make_eval_fn(Stub(), include_ladders=True)(ts)
    return captured[0].numpy()


def _jax_positions():
    return jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[jax_board_from_dsl(d, to_move=c) for d, c, _, _ in POSITIONS])


@pytest.mark.parametrize("batch", range(3))
def test_laddered_stones_parity(jax_planes, batch):
    """The six textbook positions and 18 random-play boards, 8 at a time,
    identity symmetry: the port's planes equal JAX's, so laddered_stones
    (planes 13 | 14) does."""
    if batch == 0:
        js = _cat(_jax_positions(), random_jax_states(B=2, moves=90, seed=21))
    else:
        js = random_jax_states(B=B, moves=30 * batch + 30, seed=batch, pass_prob=0.05)
    js = _with_sym(js, np.zeros(B, np.int64))
    want = jax_planes(js)
    ts = state_to_torch(js)
    before = laddered_stones.syncs
    planes = _torch_planes(ts)  # one laddered_stones call
    assert 1 <= laddered_stones.syncs - before <= MAX_DEPTH // LADDER_CHUNK + 1
    np.testing.assert_array_equal(planes, want)
    got = torch.from_numpy((planes[..., 13] + planes[..., 14]).reshape(B, 361) > 0)
    if batch == 0:
        for k, (_, _, (i, j), lad) in enumerate(POSITIONS):
            assert bool(got[k, i * 19 + j]) == lad, k
        assert int(got[0].sum()) == 1  # the driving stones are not laddered
    else:
        assert got.any()  # the random boards hold laddered stones


def test_ladder_planes_under_symmetry(jax_planes):
    """The working ladder under symmetries 0-7: the port's planes equal
    JAX's, including the four symmetries under which nothing is marked."""
    js = jax_board_from_dsl(POSITIONS[0][0], to_move=1)
    js = jax.tree_util.tree_map(lambda x: jnp.stack([x] * B), js)
    js = _with_sym(js, np.arange(B))
    want = jax_planes(js)
    got = _torch_planes(state_to_torch(js))
    np.testing.assert_array_equal(got, want)
    marked = (got[..., 13] + got[..., 14]).reshape(B, -1).sum(axis=1)
    assert {s for s in range(B) if marked[s] == 0} == {1, 2, 4, 7}
    assert (marked[[0, 3, 5, 6]] == 1).all()


def test_board_from_dsl_ladder_matches_jax_labels():
    """The port's from_stones labels the DSL ladder as JAX does, so the
    candidates agree before any symmetry."""
    js = jax_board_from_dsl(POSITIONS[0][0], to_move=1)
    ts = board_from_dsl(POSITIONS[0][0], to_move=1, device="cpu")
    np.testing.assert_array_equal(ts.chain_id[0].numpy(), np.asarray(js.chain_id))
    assert bool(laddered_stones(ts)[0, 9 * 19 + 9])
