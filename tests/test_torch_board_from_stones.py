"""The port's `from_stones` (p3achygo_tpu_torch/game/board.py) and ASCII
DSL (game/dsl.py) held against the JAX package: every state field, the
chain ids, hashes, history and per-point liberties equal exactly, on
random stone arrays, on played-out boards and on the DSL strings of
tests/test_board.py (read from that file's source)."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game import dsl as jdsl
from p3achygo_tpu.game.board import from_stones as jax_from_stones
from p3achygo_tpu.game.board import point_liberties as jax_point_liberties
from p3achygo_tpu_torch.constants import BLACK, WHITE
from p3achygo_tpu_torch.game import dsl as tdsl
from p3achygo_tpu_torch.game.board import GoState, from_stones, map_state, point_liberties
from torch_parity import random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

_jax_from_stones = jax.jit(jax.vmap(jax_from_stones))
_jax_libs = jax.jit(jax.vmap(jax_point_liberties))


def _assert_state_equal(js, ts: GoState):
    for f in GoState._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), to_np(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(point_liberties(ts.stones, ts.chain_id).numpy(),
                                  np.asarray(_jax_libs(js.stones, js.chain_id)))


def _random_stones(B: int, seed: int) -> np.ndarray:
    """Stone arrays of varied density, legal or not (from_stones takes any)."""
    rng = np.random.default_rng(seed)
    density = rng.uniform(0.05, 0.9, (B, 1))
    occupied = rng.random((B, 361)) < density
    return np.where(occupied, rng.choice([BLACK, WHITE], (B, 361)), 0).astype(np.int8)


@pytest.mark.parametrize("source", ["random", "played"])
def test_from_stones_matches_jax(source):
    B = 12
    if source == "random":
        stones = _random_stones(B, seed=3)
    else:
        stones = np.array(random_jax_states(B, 90, seed=8, pass_prob=0.05).stones)
    rng = np.random.default_rng(4)
    komi = rng.choice([-0.5, 0.5, 7.5, 20.5], B).astype(np.float32)
    to_move = rng.choice([BLACK, WHITE], B).astype(np.int8)
    want = _jax_from_stones(jnp.asarray(stones), jnp.asarray(komi), jnp.asarray(to_move))
    got = from_stones(torch.from_numpy(stones), torch.from_numpy(komi),
                      torch.from_numpy(to_move), device="cpu")
    _assert_state_equal(want, got)
    assert (got.history[:, 1:] == 0).all() and (got.history_len == 1).all()


def test_from_stones_scalar_komi_and_color():
    stones = _random_stones(3, seed=5)
    got = from_stones(stones, 7.5, WHITE, device="cpu")
    want = _jax_from_stones(jnp.asarray(stones), jnp.full((3,), 7.5, jnp.float32),
                            jnp.full((3,), WHITE, jnp.int8))
    _assert_state_equal(want, got)


def _test_board_dsl_cases():
    """(dsl, to_move, komi) of every board_from_dsl call in tests/test_board.py
    whose arguments are literals."""
    path = os.path.join(os.path.dirname(__file__), "test_board.py")
    cases = []
    for node in ast.walk(ast.parse(open(path).read())):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "board_from_dsl"
                and node.args and isinstance(node.args[0], ast.Constant)):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        color = kw.get("to_move")
        to_move = WHITE if isinstance(color, ast.Name) and color.id == "WHITE" else BLACK
        komi = kw["komi"].value if isinstance(kw.get("komi"), ast.Constant) else 7.5
        cases.append((node.args[0].value, to_move, komi))
    return cases


DSL_CASES = _test_board_dsl_cases()


def test_dsl_cases_found():
    assert len(DSL_CASES) >= 12


def test_board_from_dsl_matches_jax():
    for dsl, to_move, komi in DSL_CASES:
        np.testing.assert_array_equal(tdsl.parse_dsl(dsl), jdsl.parse_dsl(dsl))
        want = jax.tree_util.tree_map(lambda x: x[None],
                                      jdsl.board_from_dsl(dsl, komi=komi, to_move=to_move))
        got = tdsl.board_from_dsl(dsl, komi=komi, to_move=to_move, device="cpu")
        _assert_state_equal(want, got)
        assert tdsl.render(got.stones[0]) == jdsl.render(np.asarray(want.stones[0]))


def test_dsl_rejects_what_jax_rejects():
    for bad in ("x y", "\n".join(["."] * 20), "." * 20):
        with pytest.raises(ValueError):
            jdsl.parse_dsl(bad)
        with pytest.raises(ValueError):
            tdsl.parse_dsl(bad)


def test_from_stones_of_played_boards_rebuilds_their_chains():
    """A played-out board rebuilt from its stones has the same chains and
    hash as the board the moves built."""
    played = state_to_torch(random_jax_states(6, 120, seed=11))
    rebuilt = from_stones(played.stones, played.komi, played.to_move, device="cpu")
    np.testing.assert_array_equal(rebuilt.chain_id.numpy(), played.chain_id.numpy())
    np.testing.assert_array_equal(rebuilt.hash.numpy(), played.hash.numpy())
    one = map_state(lambda t: t[:1], rebuilt)
    assert one.stones.shape == (1, 361)
