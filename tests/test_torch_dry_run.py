"""Exact move legality of the PyTorch port held against the JAX package:
`dry_run_status` and `full_legal_mask` on random-play boards and on
from_stones positions that reach every status code (occupied, self-capture,
the pass-alive ban, positional superko by a ko recapture, pass and
out-of-bounds actions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game import board as jb
from p3achygo_tpu.game.dsl import parse_dsl as jax_parse_dsl
from p3achygo_tpu_torch.game import board as tb
from torch_parity import _jit_step, random_jax_states, state_to_torch

torch.set_num_threads(2)

_jax_statuses = jax.jit(jax.vmap(jax.vmap(jb.dry_run_status, in_axes=(None, 0)),
                                 in_axes=(0, None)))
_jax_full = jax.jit(jax.vmap(jb.full_legal_mask))
ACTIONS = np.arange(-1, 363, dtype=np.int32)  # out of bounds, points, pass, 362

# A ko in the corner (white at 1-1 in atari, black takes at 1-2, white
# retakes), and a settled endgame: black owns columns 0-9 and white
# columns 10-18, each group with two one-point eyes, so the mover's moves
# are the own eyes, the opponent's eyes (self-capture) and the pass. Both
# groups are pass-alive, so with Benson's regions set every eye is banned.
_KO = """
. x o . .
x o . o .
. x o . .
"""


def _settled() -> np.ndarray:
    s = np.zeros((19, 19), np.int8)
    s[:, :10] = 1
    s[:, 10:] = -1
    for r, c in ((3, 3), (15, 3), (3, 15), (15, 15)):
        s[r, c] = 0
    return s.reshape(-1)


def _jax_positions():
    """[4] JAX states from from_stones, each then one ply on: the ko after
    black's capture (white to move; the retake repeats the start), the
    settled board after a white pass with its Benson regions (black to
    move), the settled board after a black pass with no regions (white to
    move), and the ko after a black pass (white to move)."""
    ko, settled = jax_parse_dsl(_KO), _settled()
    sb = jax.vmap(jb.from_stones)(jnp.asarray(np.stack([ko, settled, settled, ko])),
                                  jnp.full((4,), 7.5), jnp.asarray([1, -1, 1, 1], jnp.int8))
    regions = np.where(np.arange(361) % 19 < 10, 1, -1).astype(np.int8)
    pa = np.zeros((4, 361), np.int8)
    pa[1] = regions
    sb = sb._replace(pass_alive=jnp.asarray(pa))
    after, _ = _jit_step(sb, jnp.asarray([1 * 19 + 2, 361, 361, 361], jnp.int32))
    return after


def _check(js, expect_codes=()):
    ts = state_to_torch(js)
    want = np.asarray(_jax_statuses(js, jnp.asarray(ACTIONS)))  # [B, A]
    B, A = want.shape
    # Every (board, action) pair as one batch of B*A boards.
    lanes = tb.map_state(lambda t: t.repeat_interleave(A, dim=0), ts)
    got = tb.dry_run_status(lanes, torch.from_numpy(np.tile(ACTIONS, B))).numpy().reshape(B, A)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    for code in expect_codes:
        assert (got == code).any(), code
    np.testing.assert_array_equal(tb.full_legal_mask(ts).numpy(),
                                  np.asarray(_jax_full(js)))
    return got


@pytest.mark.parametrize("moves,pass_prob,seed", [(40, 0.0, 1), (150, 0.05, 2)])
def test_dry_run_random_play(moves, pass_prob, seed):
    js = random_jax_states(B=4, moves=moves, seed=seed, pass_prob=pass_prob)
    got = _check(js, (tb.MOVE_VALID, tb.MOVE_LOC_NOT_EMPTY))
    # Pass, -1 and 362 are passes: valid.
    assert (got[:, [0, -2, -1]] == tb.MOVE_VALID).all()


def test_dry_run_every_status_code():
    js = _jax_positions()
    got = _check(js, (tb.MOVE_VALID, tb.MOVE_LOC_NOT_EMPTY, tb.MOVE_SELF_CAPTURE,
                      tb.MOVE_PASS_ALIVE_REGION, tb.MOVE_REPEATED_POSITION))
    a = lambda p: int(np.flatnonzero(ACTIONS == p)[0])
    assert got[0, a(1 * 19 + 1)] == tb.MOVE_REPEATED_POSITION  # the ko retake
    assert got[1, a(3 * 19 + 3)] == tb.MOVE_PASS_ALIVE_REGION  # own eye
    assert got[1, a(3 * 19 + 15)] == tb.MOVE_PASS_ALIVE_REGION  # opponent's eye
    assert got[2, a(3 * 19 + 3)] == tb.MOVE_SELF_CAPTURE  # opponent's eye
    assert got[2, a(3 * 19 + 15)] == tb.MOVE_VALID  # own eye, no regions
    assert (got[3] == tb.MOVE_REPEATED_POSITION).sum() == 0


def test_full_legal_mask_matches_step_statuses():
    """The mask is exactly the actions `step` plays without a pass."""
    js = random_jax_states(B=2, moves=60, seed=7, pass_prob=0.1)
    ts = state_to_torch(js)
    mask = tb.full_legal_mask(ts)
    for a in range(0, 362, 19):
        _, status = tb.step(ts, torch.full((2,), a))
        np.testing.assert_array_equal(mask[:, a].numpy(),
                                      (status == tb.MOVE_VALID).numpy())
