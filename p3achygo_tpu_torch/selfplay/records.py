"""Per-game training-record extraction, host side (port of
p3achygo_tpu/selfplay/records.py; a copy, so the port imports nothing of
the JAX package).

Mirrors the reference's game-replay recorder (cc/recorder/tf_recorder.cc
:120-280): one example per *trainable* move with improved policy, next-move
aux targets, ownership, score margin, exp-weighted TD value targets
(λ = 5/6, 15/16, 49/50 with alternating turn sign, tf_recorder.cc:186-215),
and policy-surprise frequency weights (0.5 + 0.5 * kld / avg_kld,
tf_recorder.cc:224-235). Instead of duplicating examples ∝ weight into a
file chunk, the weight is stored and used as a sampling weight in the
replay buffer — same expectation, no file relay.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from p3achygo_tpu_torch.constants import (
    BLACK,
    NUM_LOCS,
    NUM_MOVES,
    PASS_MOVE,
    WHITE,
)


@dataclasses.dataclass
class GameExamples:
    """Columnar per-move training examples for one finished game."""

    stones: np.ndarray  # int8[M, 361]
    last_moves: np.ndarray  # int16[M, 5]
    color: np.ndarray  # int8[M]
    komi: np.ndarray  # f32[M]
    pi: np.ndarray  # f32[M, 362]
    pi_aux: np.ndarray  # int16[M] next-move encoding (pass at end)
    pi_aux_dist: np.ndarray  # f32[M, 362]
    has_pi_aux_dist: np.ndarray  # bool[M]
    own: np.ndarray  # int8[M, 361] player-perspective {-1, 0, 1}
    score_margin: np.ndarray  # f32[M] player perspective
    z: np.ndarray  # f32[M] +-1 game outcome for player
    q6: np.ndarray  # f32[M]
    q16: np.ndarray
    q50: np.ndarray
    q6_score: np.ndarray
    q16_score: np.ndarray
    q50_score: np.ndarray
    weight: np.ndarray  # f32[M] surprise sampling weight
    mcts_value_dist: np.ndarray  # u16[M, 51] root value histogram

    def __len__(self):
        return self.stones.shape[0]


def _exp_weighted(values: np.ndarray, t: int, lam: float, horizon: int):
    """(1/N) sum_i (-1)^i lam^i values[t+i], i = 0..horizon (scalar ref)."""
    idx = np.arange(horizon + 1)
    w = lam ** idx
    sign = np.where(idx % 2 == 0, 1.0, -1.0)
    return float(np.sum(sign * w * values[t:t + horizon + 1]) / np.sum(w))


def _exp_weighted_all(values: np.ndarray, lam: float,
                      horizon: int | None) -> np.ndarray:
    """Vectorized _exp_weighted for every t at once.

    horizon None => to end of game (lambda=49/50 case): backward recursion
    u_t = v_t + (-lam) * u_{t+1}; else truncated sliding correlation with
    kernel (-lam)^i.
    """
    L = len(values)
    if L == 0:
        return np.zeros(0)
    if horizon is None:
        u = np.zeros(L)
        acc = 0.0
        for t in range(L - 1, -1, -1):
            acc = values[t] - lam * acc
            u[t] = acc
        h = np.arange(L - 1, -1, -1)  # available horizon per t
    else:
        H = min(horizon, L - 1)
        kern = (-lam) ** np.arange(H + 1)
        u_full = np.convolve(values, kern[::-1], mode="full")[H:H + L]
        # tail positions have fewer terms: recompute the ragged tail
        u = u_full
        for t in range(max(L - H, 0), L):
            k = L - t
            u[t] = np.sum(kern[:k] * values[t:])
        h = np.minimum(horizon, L - 1 - np.arange(L))
    norm = (1.0 - lam ** (h + 1)) / (1.0 - lam)
    return u / norm


def finalize_game(
    stones: np.ndarray,  # int8[T, 361] per-move pre-move position
    last_moves: np.ndarray,  # int16[T, 5]
    to_move: np.ndarray,  # int8[T]
    pi: np.ndarray,  # f32[T, 362]
    move: np.ndarray,  # int16[T]
    root_q_outcome: np.ndarray,  # f32[T]
    root_score: np.ndarray,  # f32[T]
    kld: np.ndarray,  # f32[T]
    trainable: np.ndarray,  # bool[T]
    num_moves: int,
    black_score: float,
    white_score: float,
    ownership: np.ndarray,  # int8[361] final {0, 1, -1}
    komi: float,
    mcts_value_dist: np.ndarray = None,  # int16[T, 51] or None
) -> Optional[GameExamples]:
    """Convert one finished game's move records into training examples."""
    L = int(num_moves)
    if L <= 0:
        return None
    winner = BLACK if black_score > white_score else WHITE

    tr_idx = np.flatnonzero(trainable[:L])
    if tr_idx.size == 0:
        return None

    kld_sum = float(kld[tr_idx].sum())
    avg_kld = kld_sum / tr_idx.size if tr_idx.size else 0.0

    vals = root_q_outcome[:L].astype(np.float64)
    svals = root_score[:L].astype(np.float64)

    M = tr_idx.size
    ex = GameExamples(
        stones=stones[tr_idx].astype(np.int8),
        last_moves=last_moves[tr_idx].astype(np.int16),
        color=to_move[tr_idx].astype(np.int8),
        komi=np.full((M,), komi, np.float32),
        pi=pi[tr_idx].astype(np.float32),
        pi_aux=np.zeros((M,), np.int16),
        pi_aux_dist=np.zeros((M, NUM_MOVES), np.float32),
        has_pi_aux_dist=np.zeros((M,), bool),
        own=np.zeros((M, NUM_LOCS), np.int8),
        score_margin=np.zeros((M,), np.float32),
        z=np.zeros((M,), np.float32),
        q6=np.zeros((M,), np.float32),
        q16=np.zeros((M,), np.float32),
        q50=np.zeros((M,), np.float32),
        q6_score=np.zeros((M,), np.float32),
        q16_score=np.zeros((M,), np.float32),
        q50_score=np.zeros((M,), np.float32),
        weight=np.ones((M,), np.float32),
        mcts_value_dist=(mcts_value_dist[tr_idx].astype(np.uint16)
                         if mcts_value_dist is not None
                         else np.zeros((M, 51), np.uint16)),
    )

    colors = to_move[tr_idx].astype(np.int8)
    ex.z[:] = np.where(colors == winner, 1.0, -1.0)
    bm = black_score - white_score
    ex.score_margin[:] = np.where(colors == BLACK, bm, -bm)
    ex.own[:] = ownership[None, :].astype(np.int8) * colors[:, None]
    has_next = tr_idx < L - 1
    nxt = np.clip(tr_idx + 1, 0, L - 1)
    ex.pi_aux[:] = np.where(has_next, move[nxt], PASS_MOVE).astype(np.int16)
    ex.pi_aux_dist[:] = np.where(has_next[:, None], pi[nxt], 0.0)
    ex.has_pi_aux_dist[:] = has_next
    q6_all = _exp_weighted_all(vals, 5.0 / 6.0, 6)
    q16_all = _exp_weighted_all(vals, 15.0 / 16.0, 16)
    q50_all = _exp_weighted_all(vals, 49.0 / 50.0, None)
    s6_all = _exp_weighted_all(svals, 5.0 / 6.0, 6)
    s16_all = _exp_weighted_all(svals, 15.0 / 16.0, 16)
    s50_all = _exp_weighted_all(svals, 49.0 / 50.0, None)
    ex.q6[:] = q6_all[tr_idx]
    ex.q16[:] = q16_all[tr_idx]
    ex.q50[:] = q50_all[tr_idx]
    ex.q6_score[:] = s6_all[tr_idx]
    ex.q16_score[:] = s16_all[tr_idx]
    ex.q50_score[:] = s50_all[tr_idx]
    if avg_kld != 0.0:
        ex.weight[:] = 0.5 + 0.5 * kld[tr_idx].astype(np.float64) / avg_kld
    return ex

