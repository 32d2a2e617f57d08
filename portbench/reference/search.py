"""The search's outputs that can be worked out without its tree, in plain
NumPy: the tier sizes of a lockstep step, the sequential-halving schedule
of an (n, k) search, the visits one search adds below its root, and the
completed-Q improved policy it records as the move's target (upstream
p3achygo's gumbel.cc: its halving rounds and ComputeRootImprovedPolicy).

The policy is worked out from the reference's own priors and legal moves
and from three numbers of the program's tree a root has: its children's
visit counts and Q after the search, and its own utility. Mixes with early
stopping or over-search (whose visits depend on the tree) are not covered.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

BIG_NEG = -1e9


def tier_sizes(batch: int, selected_share: float) -> Tuple[int, int]:
    """(selected, fast) boards of one step with one tier group: the
    selected tier gets round(B * share) boards, at least one of each."""
    sel = min(max(int(round(batch * selected_share)), 1), batch - 1)
    return sel, batch - sel


def schedule(n: int, k: int) -> List[Tuple[int, int]]:
    """[(k_r, v_r)]: log2(k) rounds (at least one), round r keeping k_r
    candidates and giving each v_r = round(n / (rounds * k_r)) visits (at
    least one), k_r halving down to 2."""
    rounds = max(int(math.log2(k)) if k > 1 else 1, 1)
    out, k_r = [], k
    while k_r > 1:
        out.append((k_r, max(int(round(n / (rounds * k_r))), 1)))
        k_r //= 2
    return out


def visits_added(n: int, k: int, n_legal: int) -> int:
    """The visits an (n, k) search adds below a root of a game not over
    with `n_legal` legal moves: each round's v_r for each of its live
    candidates, of which there are min(k_r, n_legal)."""
    return sum(v * min(k_r, n_legal) for k_r, v in schedule(n, k))


def improved_policy(logp: np.ndarray, legal: np.ndarray, visits: np.ndarray, q: np.ndarray,
                    v_mix: np.ndarray, n: np.ndarray, k: np.ndarray, c_visit: float,
                    c_scale: float) -> np.ndarray:
    """float64[R, 362]: the completed-Q improved policy of R roots.
    logp [R, 362] the priors' logs; legal bool[R, 362]; visits / q
    [R, 362] the children's visits and Q after the search (q read only
    where visited); v_mix [R] the root's own utility, which completes the
    unvisited children; n / k [R] each root's search. The logits are the
    legal priors plus (c_visit + 2 log(W + 1)) c_scale times the completed
    Q mapped from [-1.1, 1.1] onto [0, 1], W being the visits the winner
    gets by the schedule."""
    logp = np.where(legal, logp.astype(np.float64), BIG_NEG)
    winner = np.array([sum(v for _, v in schedule(int(a), int(b))) for a, b in zip(n, k)],
                      np.float64)
    coef = (c_visit + 2.0 * np.log(winner + 1.0)) * c_scale
    completed = np.where(visits > 0, (q.astype(np.float64) + 1.1) / 2.2,
                         ((v_mix.astype(np.float64) + 1.1) / 2.2)[:, None])
    logits = logp + coef[:, None] * completed
    logits -= logits.max(axis=1, keepdims=True)
    e = np.exp(logits)
    return e / e.sum(axis=1, keepdims=True)
