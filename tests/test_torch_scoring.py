"""The port's Benson scoring (p3achygo_tpu_torch/game/scoring.py and
selfplay/loop.py final_scores) held against the JAX package on the same
positions: the Benson positions of tests/test_board.py (built with each
package's own DSL), a few more with pass-alive groups and dead stones,
and 16 random played-out boards. Labels, pass-alive maps and ownership must be
equal, and the scores equal as float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game import scoring as js
from p3achygo_tpu.game.dsl import board_from_dsl
from p3achygo_tpu.selfplay.loop import final_scores as jax_final_scores
from p3achygo_tpu_torch.constants import BLACK, WHITE
from p3achygo_tpu_torch.game import dsl as tdsl
from p3achygo_tpu_torch.game import scoring as ts
from p3achygo_tpu_torch.game.board import compute_chains, map_state
from p3achygo_tpu_torch.selfplay.loop import final_scores
from torch_parity import random_jax_states, state_to_torch

torch.set_num_threads(2)


def _walls():
    rows = []
    for _ in range(19):
        row = ["."] * 19
        row[2], row[4] = "x", "o"
        rows.append(" ".join(row))
    return "\n".join(rows)


BENSON_BOARDS = [
    ("", BLACK),
    (_walls(), BLACK),
    (""". x . x .
        x x x x x
        o . . . .""", BLACK),
    (""". x . x .
        x x x x x""", BLACK),
    (""". x . . .
        x x . . .""", BLACK),
    (""". . . x .
        x x x x .""", BLACK),
    # Two-eyed white corner beside a black group with one real eye.
    (""". o . o x . x
        o o o o x x x
        x x x x x . .""", WHITE),
    # A dead white stone inside a two-eyed black group's eye space.
    (""". x . . x
        x x o . x
        x . x x x
        x x x . .""", BLACK),
    # Snake-shaped empty region along black walls (long label propagation).
    ("\n".join(" ".join("x" if (r % 2 == 1 and (c < 18 if r % 4 == 1 else c > 0))
                        else "." for c in range(19)) for r in range(12)), BLACK),
]


def _stack(states):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


MASKS = {"empty": lambda s: s == 0, "black": lambda s: s == 1,
         "not_white": lambda s: s != -1}


@jax.jit
def _jax_oracle(st):
    """Every JAX result the tests compare with, in one compiled program."""
    out = {f"labels_{k}": jax.vmap(js.label_components)(fn(st.stones))
           for k, fn in MASKS.items()}
    for c in (BLACK, WHITE):
        out[f"pa_{c}"] = jax.vmap(js.pass_alive_for_color, in_axes=(0, 0, None))(
            st.stones, st.chain_id, jnp.int8(c))
    out["pass_alive"] = jax.vmap(js.compute_pass_alive)(st)
    out["score"] = jax.vmap(js.score)(st)
    out["final_scores"] = jax_final_scores(st)
    return out


@pytest.fixture(scope="module")
def boards():
    benson = _stack([board_from_dsl(d, komi=7.5, to_move=c) for d, c in BENSON_BOARDS])
    rand = random_jax_states(16, 120, seed=4, pass_prob=0.1)
    both = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]), benson, rand)
    oracle = jax.tree_util.tree_map(np.asarray, _jax_oracle(both))
    t_benson = [tdsl.board_from_dsl(d, komi=7.5, to_move=c, device="cpu")
                for d, c in BENSON_BOARDS]
    t_both = map_state(lambda *xs: torch.cat(xs), *t_benson, state_to_torch(rand))
    return both, t_both, oracle


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_label_components(boards, mask):
    _, ts_, want = boards
    got = ts.label_components(MASKS[mask](ts_.stones)).numpy()
    np.testing.assert_array_equal(got, want[f"labels_{mask}"])


def test_compute_chains(boards):
    js_, ts_, _ = boards
    np.testing.assert_array_equal(compute_chains(ts_.stones).numpy(),
                                  np.asarray(js_.chain_id))


@pytest.mark.parametrize("color", [BLACK, WHITE])
def test_pass_alive_for_color(boards, color):
    _, ts_, want = boards
    got = ts.pass_alive_for_color(ts_.stones, ts_.chain_id, color).numpy()
    np.testing.assert_array_equal(got, want[f"pa_{color}"])


def test_compute_pass_alive_and_score(boards):
    _, ts_, want = boards
    assert want["pass_alive"].any(), "no Benson position came out pass-alive"
    np.testing.assert_array_equal(ts.compute_pass_alive(ts_).numpy(), want["pass_alive"])
    for w, got in zip(want["score"], ts.score(ts_)):
        np.testing.assert_array_equal(got.numpy(), w)
    got = final_scores(ts_)
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.int8
    for w, g in zip(want["final_scores"], got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("explicit_need", [False, True])
def test_refresh_pass_alive(boards, explicit_need):
    js_, _, _ = boards
    n = js_.stones.shape[0]
    rng = np.random.default_rng(7)
    js_ = js_._replace(
        move_count=jnp.asarray(rng.choice([20, 199, 210, 260, 450], n), jnp.int32),
        pa_move=jnp.asarray(rng.choice([0, 200, 255], n), jnp.int32),
        passes=jnp.asarray(rng.integers(0, 5, n), jnp.int32),
        pass_alive=jnp.asarray(rng.choice([0, 1], (n, 361), p=[0.9, 0.1]), jnp.int8))
    ts_ = state_to_torch(js_)
    np.testing.assert_array_equal(ts.pass_alive_refresh_needed(ts_).numpy(),
                                  np.asarray(js.pass_alive_refresh_needed(js_)))
    need = jnp.asarray(rng.random(n) < 0.5) if explicit_need else None
    want = jax.jit(js.refresh_pass_alive)(js_, need)
    got = ts.refresh_pass_alive(ts_, None if need is None else torch.tensor(np.asarray(need)))
    for f in ("pass_alive", "pa_move", "stones", "move_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    none = torch.zeros(n, dtype=torch.bool)
    assert ts.refresh_pass_alive(ts_, none) is ts_
