"""Area scoring + ownership with Benson pass-alive analysis, batch-first
(port of p3achygo_tpu/game/scoring.py; reference cc/game/board.cc Benson
:246-463, ScoreAndOwnership :916-988).

The same lattice programs as the JAX package, on [B, ...] tensors:

- connected components by min-label propagation (`board.min_labels`,
  with pointer jumping and one convergence check per chunk of sweeps in
  place of a device while-loop);
- region/chain vitality as [B, 362, 362] (region rep x chain rep) count
  matrices, built by one `scatter_add_` over the flattened index
  b, r * 362 + g, the sentinel row and column kept;
- Benson's chain-removal loop as a boolean fixed point over rep arrays,
  checked once per BENSON_CHUNK sweeps. Alive sets only shrink, so a chunk
  that ends where it began has reached the JAX loop's fixed point.

Integer outputs are exactly the JAX package's; scores are the same float32
sums. Every function takes a batch; `refresh_pass_alive` skips the work
when no board needs it (one host sync).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from p3achygo_tpu_torch.constants import BLACK, EMPTY, WHITE
from p3achygo_tpu_torch.game.board import (
    SENTINEL,
    GoState,
    _nbr,
    _pad,
    min_labels,
)

_S1 = SENTINEL + 1  # reps 0..360 plus the sentinel slot
BENSON_CHUNK = 4  # chain-removal sweeps between two convergence checks

# Move counts at which self-play recomputes pass-alive regions
# (kComputePAMoveNums, self_play_thread.cc:56).
PA_CHECKPOINT_FIRST = 200
PA_CHECKPOINT_LAST = 400
PA_CHECKPOINT_STRIDE = 50
# Total passes after which the reference recomputes on every pass
# (kNumPassesBeforeBensons, constants.h:75).
PA_PASSES_THRESHOLD = 3


def _labels(mask: torch.Tensor) -> torch.Tensor:
    """int64 min-index component labels of `mask`, SENTINEL off it."""
    return min_labels(mask, _nbr(_pad(mask, False)) & mask[:, :, None])


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """Min-index connected-component labels of `mask` [B, 361] ->
    int32[B, 361], -1 off the mask."""
    return torch.where(mask, _labels(mask), -1).to(torch.int32)


def _scatter_any(idx: torch.Tensor, val: torch.Tensor, size: int = _S1
                 ) -> torch.Tensor:
    """out[b, idx[b, i]] = any of val[b, i] over i -> bool[B, size]."""
    out = torch.zeros((idx.shape[0], size), dtype=torch.int32, device=idx.device)
    out.scatter_add_(1, idx, val.to(torch.int32))
    return out > 0


def _dedup_dir_masks(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For [B, 361, 4] neighbour ids, mask each direction that is valid and
    not a duplicate of an earlier direction at the same point."""
    c = [ids[..., d] for d in range(4)]
    masks = []
    for d in range(4):
        m = valid[..., d]
        for e in range(d):
            m = m & (c[d] != c[e])
        masks.append(m)
    return torch.stack(masks, dim=-1)


def pass_alive_for_color(stones: torch.Tensor, chain_id: torch.Tensor,
                         color: int) -> torch.Tensor:
    """Benson pass-alive mask for `color` -> bool[B, 361]: stones of
    pass-alive `color` chains and all points of their surviving enclosed
    regions (board.cc:249-276). `pass_alive_for_color.sweeps` counts the
    chain-removal sweeps."""
    B = stones.shape[0]
    dev = stones.device
    is_color = stones == color
    empty = stones == EMPTY
    nonc = ~is_color  # empty or opponent: candidate region points
    region = _labels(nonc)  # SENTINEL on color stones

    nbr_color = _nbr(_pad(stones, 99))
    nbr_chain = _nbr(_pad(chain_id, -1)).long()
    nbr_is_color = nbr_color == color
    ones = torch.ones_like(empty)

    # Region enumeration starts from empty points (board.cc:303-316): a pure
    # opponent-stone component is not a region.
    reg_e = torch.where(empty, region, SENTINEL)
    has_empty = _scatter_any(reg_e, ones)
    # Small: every empty point of the region borders a `color` chain.
    bad_empty = empty & ~nbr_is_color.any(dim=2)
    region_has_bad = _scatter_any(torch.where(bad_empty, region, SENTINEL), ones)
    small = has_empty & ~region_has_bad
    small[:, SENTINEL] = False

    # V[r, g] = #empty points of region r adjacent to chain g (dedup among
    # the <=4 neighbour chains per point); A[r, g]: any region point
    # adjacent to chain g.
    gids = torch.where(nbr_is_color, nbr_chain, SENTINEL)  # [B, 361, 4]
    dirs = _dedup_dir_masks(gids, nbr_is_color)
    dmask = dirs & empty[:, :, None]
    flat = (reg_e[:, :, None] * _S1 + torch.where(dmask, gids, SENTINEL)).reshape(B, -1)
    V = torch.zeros((B, _S1 * _S1), dtype=torch.int32, device=dev)
    V.scatter_add_(1, flat, dmask.reshape(B, -1).to(torch.int32))
    V = V.view(B, _S1, _S1)
    n_empty = torch.zeros((B, _S1), dtype=torch.int32, device=dev)
    n_empty.scatter_add_(1, reg_e, ones.to(torch.int32))
    vital = (small[:, :, None] & (V == n_empty[:, :, None])
             & (n_empty[:, :, None] > 0))
    del V

    amask = dirs & nonc[:, :, None]
    aflat = (region[:, :, None] * _S1 + torch.where(amask, gids, SENTINEL)).reshape(B, -1)
    A = _scatter_any(aflat, amask.reshape(B, -1), _S1 * _S1).view(B, _S1, _S1)

    is_group = _scatter_any(torch.where(is_color, chain_id.long(), SENTINEL), ones)
    is_group[:, SENTINEL] = False

    alive_g, alive_r = is_group, small
    while True:
        before_g, before_r = alive_g, alive_r
        for _ in range(BENSON_CHUNK):
            vital_count = (alive_r[:, :, None] & vital).sum(dim=1)
            new_alive_g = alive_g & (vital_count >= 2)
            removed = alive_g & ~new_alive_g
            dead_r = (A & removed[:, None, :]).any(dim=2)
            alive_r = alive_r & ~dead_r
            alive_g = new_alive_g
        pass_alive_for_color.sweeps += BENSON_CHUNK
        if torch.equal(alive_g, before_g) and torch.equal(alive_r, before_r):
            break

    pa_stones = is_color & alive_g.gather(1, chain_id.long().clamp(0, SENTINEL))
    pa_region = nonc & alive_r.gather(1, region)
    return pa_stones | pa_region


pass_alive_for_color.sweeps = 0


def compute_pass_alive(states: GoState) -> torch.Tensor:
    """Combined pass-alive ownership -> int8[B, 361] in {0, BLACK, WHITE}."""
    pa_b = pass_alive_for_color(states.stones, states.chain_id, BLACK)
    pa_w = pass_alive_for_color(states.stones, states.chain_id, WHITE)
    return (pa_b.to(torch.int8) * BLACK + pa_w.to(torch.int8) * WHITE)


def pass_alive_refresh_needed(states: GoState) -> torch.Tensor:
    """bool[B]: board crossed a PA checkpoint (or is in the >= 3-passes
    endgame regime) since its last refresh. The JAX package's documented
    deviation carries over: a board refreshes at the first poll after
    crossing a boundary, not at the exact move number."""
    mc = states.move_count
    ck = mc.clamp(0, PA_CHECKPOINT_LAST) // PA_CHECKPOINT_STRIDE
    ck_prev = states.pa_move.clamp(0, PA_CHECKPOINT_LAST) // PA_CHECKPOINT_STRIDE
    crossed = (mc >= PA_CHECKPOINT_FIRST) & (ck > ck_prev)
    endgame = (states.passes >= PA_PASSES_THRESHOLD) & (mc > states.pa_move)
    return crossed | endgame


def refresh_pass_alive(states: GoState,
                       need: Optional[torch.Tensor] = None) -> GoState:
    """Recompute the pass-alive maps of the boards in `need` (default:
    pass_alive_refresh_needed); the others keep theirs. When no board
    needs it nothing is computed (one host sync)."""
    if need is None:
        need = pass_alive_refresh_needed(states)
    if not bool(need.any()):
        return states
    pa = compute_pass_alive(states)
    return states._replace(
        pass_alive=torch.where(need[:, None], pa, states.pass_alive),
        pa_move=torch.where(need, states.move_count, states.pa_move))


def _score_one_color(stones: torch.Tensor, pass_alive: torch.Tensor,
                     color: int, komi: torch.Tensor):
    """Score f32[B] + ownership bool[B, 361] for one color
    (board.cc:916-988)."""
    empty = stones == EMPTY
    is_color = stones == color
    is_opp = stones == -color
    dead_opp = is_opp & (pass_alive == color)
    live_opp = is_opp & ~dead_opp
    # Live own stones: not sitting inside the opponent's pass-alive area.
    live_self = is_color & ~(pass_alive == -color)

    regmask = empty | dead_opp
    reg = _labels(regmask)  # SENTINEL off regmask
    touches_self = (_nbr(_pad(stones, 99)) == color).any(dim=2)
    touches_live_opp = _nbr(_pad(live_opp, False)).any(dim=2)
    t_self = _scatter_any(reg, touches_self & regmask)
    t_opp = _scatter_any(reg, touches_live_opp & regmask)
    counted = t_self & ~t_opp
    counted[:, SENTINEL] = False

    ownership = live_self | (regmask & counted.gather(1, reg))
    score = ownership.sum(dim=1, dtype=torch.int32).to(torch.float32)
    if color == WHITE:
        score = score + komi
    return score, ownership


def score(states: GoState) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Final scores + ownership -> (black f32[B], white f32[B], ownership
    int8[B, 361]), Board::GetScores (board.cc:645-672): black's claim wins
    ties in the merged ownership map."""
    pa = compute_pass_alive(states)
    b_score, b_own = _score_one_color(states.stones, pa, BLACK, states.komi)
    w_score, w_own = _score_one_color(states.stones, pa, WHITE, states.komi)
    ownership = torch.where(b_own, BLACK, torch.where(w_own, WHITE, EMPTY)).to(torch.int8)
    return b_score, w_score, ownership
