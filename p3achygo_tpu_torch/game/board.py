"""Batched Go rules engine on tensors (port of p3achygo_tpu/game/board.py).

Every function takes a batch-first `GoState` ([B, ...] tensors) and returns
new tensors; nothing is vmapped. Semantics are those of the JAX engine
(reference cc/game/board.cc PlayMove :536-595, superko :637-639,
self-capture ban :900-914):

- chains carry a representative point index (`chain_id`, -1 on empty);
  placing a stone merges the <=4 neighbour chains by compare-and-select;
- per-point liberties come from `ops/liberties.py` (the CUDA kernel on a
  card, the plain version on the CPU);
- positional superko uses the additive 2-lane Zobrist hash, built from the
  same numpy generator as the JAX table so hashes agree bit for bit. torch
  has no uint32 add on the CPU, so each lane is an int64 holding a value in
  [0, 2**32), masked with `& 0xFFFFFFFF` after every add.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from p3achygo_tpu_torch.constants import (
    BLACK,
    BOARD_LEN,
    DEFAULT_KOMI,
    EMPTY,
    MAX_HISTORY,
    NOOP_MOVE,
    NUM_LAST_MOVES,
    NUM_LOCS,
    PASS_MOVE,
    WHITE,
)
from p3achygo_tpu_torch.tables import DeviceTable

# Move status codes (cc/game/board.h:54-66 MoveStatus).
MOVE_VALID = 0
MOVE_UNKNOWN_COLOR = 1
MOVE_OUT_OF_BOUNDS = 2
MOVE_LOC_NOT_EMPTY = 3
MOVE_SELF_CAPTURE = 4
MOVE_REPEATED_POSITION = 5
MOVE_PASS_ALIVE_REGION = 6

SENTINEL = NUM_LOCS  # padded gather slot for off-board neighbours
HASH_MASK = 0xFFFFFFFF


def _build_neighbors() -> np.ndarray:
    """[361, 4] neighbour indices (up, down, left, right); off-board -> 361."""
    nbrs = np.full((NUM_LOCS, 4), SENTINEL, dtype=np.int64)
    for i in range(BOARD_LEN):
        for j in range(BOARD_LEN):
            p = i * BOARD_LEN + j
            if i > 0:
                nbrs[p, 0] = (i - 1) * BOARD_LEN + j
            if i < BOARD_LEN - 1:
                nbrs[p, 1] = (i + 1) * BOARD_LEN + j
            if j > 0:
                nbrs[p, 2] = i * BOARD_LEN + (j - 1)
            if j < BOARD_LEN - 1:
                nbrs[p, 3] = i * BOARD_LEN + (j + 1)
    return nbrs


NEIGHBORS = DeviceTable(_build_neighbors(), torch.int64)

# Additive Zobrist table [362, 3 states, 2 lanes]: the JAX package's
# generator and seed (board.py:87-90); the sentinel row stays zero. State
# index is stones + 1: WHITE=0, EMPTY=1, BLACK=2.
_ZOB_RNG = np.random.default_rng(0x9E3779B97F4A7C15 % (2**32))
_ZOB = _ZOB_RNG.integers(0, 2**32, size=(NUM_LOCS + 1, 3, 2), dtype=np.uint64)
_ZOB[SENTINEL] = 0
ZOBRIST = DeviceTable(_ZOB.astype(np.int64), torch.int64)


class GoState(NamedTuple):
    """Batched game state; every field has the batch axis first."""

    stones: torch.Tensor  # int8[B, 361] in {0, 1, -1}
    chain_id: torch.Tensor  # int32[B, 361]; rep point index, -1 empty
    hash: torch.Tensor  # int64[B, 2], each lane in [0, 2**32)
    history: torch.Tensor  # int64[B, H, 2] seen-position ring
    history_len: torch.Tensor  # int32[B]
    last_moves: torch.Tensor  # int32[B, 5], oldest..newest; -1 noop, 361 pass
    to_move: torch.Tensor  # int8[B]
    ko_point: torch.Tensor  # int32[B], -1 none
    consecutive_passes: torch.Tensor  # int32[B]
    passes: torch.Tensor  # int32[B]
    move_count: torch.Tensor  # int32[B]
    komi: torch.Tensor  # float32[B]
    num_b_prisoners: torch.Tensor  # int32[B]
    num_w_prisoners: torch.Tensor  # int32[B]
    pass_alive: torch.Tensor  # int8[B, 361] Benson region map (carried)
    pa_move: torch.Tensor  # int32[B]


def map_state(fn, *states):
    """Apply `fn` field by field across NamedTuples of tensors."""
    return type(states[0])(*[fn(*xs) for xs in zip(*states)])


def select_state(mask: torch.Tensor, a, b):
    """Row-wise `where(mask, a, b)` over every field of two NamedTuples."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)
    return map_state(sel, a, b)


def _pad(x: torch.Tensor, fill) -> torch.Tensor:
    """Append a sentinel column so NEIGHBORS gathers are branch-free."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, col], dim=1)


def _nbr(x_padded: torch.Tensor) -> torch.Tensor:
    """[B, 362] padded point values -> [B, 361, 4] neighbour values."""
    nb = NEIGHBORS.on(x_padded.device)
    return x_padded[:, nb]


def compute_hash(stones: torch.Tensor) -> torch.Tensor:
    """Additive zobrist of full positions [B, 361] -> int64[B, 2]."""
    z = ZOBRIST.on(stones.device)[:NUM_LOCS]  # [361, 3, 2]
    idx = stones.long() + 1
    pts = torch.arange(NUM_LOCS, device=stones.device)
    picked = z[pts[None, :], idx]  # [B, 361, 2]
    return picked.sum(dim=1) & HASH_MASK


def chain_lib_counts(stones: torch.Tensor, chain_id: torch.Tensor
                     ) -> torch.Tensor:
    """Liberty count per chain representative -> int32[B, 362].

    Each empty point adds one liberty to each distinct adjacent chain
    (pairwise dedup of the <=4 neighbour ids), accumulated with
    `scatter_add_`. Chain ids outside [0, 361) count as no chain.
    """
    B = stones.shape[0]
    empty = (stones == EMPTY)[:, :, None]
    nbr_chain = _nbr(_pad(chain_id, -1))  # [B, 361, 4]
    c = [nbr_chain[:, :, d] for d in range(4)]
    masks = []
    for d in range(4):
        m = (c[d] >= 0) & (c[d] < NUM_LOCS)
        for e in range(d):
            m = m & (c[d] != c[e])
        masks.append(m)
    mask = torch.stack(masks, dim=2) & empty  # [B, 361, 4]
    ids = torch.where(mask, nbr_chain, SENTINEL).long().reshape(B, -1)
    counts = torch.zeros((B, NUM_LOCS + 1), dtype=torch.int32,
                         device=stones.device)
    counts.scatter_add_(1, ids, mask.reshape(B, -1).to(torch.int32))
    return counts


def point_liberties(stones: torch.Tensor, chain_id: torch.Tensor
                    ) -> torch.Tensor:
    """Per-point liberty count of the point's chain -> int32[B, 361]
    (0 on empty points). Plain tensor version of the liberty kernel."""
    counts = chain_lib_counts(stones, chain_id)
    valid = (chain_id >= 0) & (chain_id < NUM_LOCS)
    gathered = counts.gather(1, torch.where(valid, chain_id, SENTINEL).long())
    return torch.where((stones != EMPTY) & valid, gathered,
                       torch.zeros_like(gathered))


LABEL_CHUNK = 4  # label sweeps between two convergence checks


def min_labels(mask: torch.Tensor, link: torch.Tensor) -> torch.Tensor:
    """Min-point-index labels of the components of `mask` [B, 361] ->
    int64[B, 361], SENTINEL off the mask. `link` [B, 361, 4] marks, per
    mask point and direction, that the neighbour there is in the same
    component; it is false at every point off the mask.

    Each sweep takes the minimum over linked neighbours, then jumps every
    label to its label's label (pointer jumping: the label of a point is a
    point of the same component with a smaller or equal index). Labels
    only fall and the min-index labelling is the unique fixed point, so
    extra sweeps change nothing: the host checks for convergence once per
    LABEL_CHUNK sweeps, one sync each. `min_labels.sweeps` counts sweeps."""
    B = mask.shape[0]
    dev = mask.device
    nb = NEIGHBORS.on(dev)
    iota = torch.arange(NUM_LOCS, dtype=torch.int64, device=dev)
    lbl = torch.where(mask, iota, SENTINEL)
    sent = torch.full((B, 1), SENTINEL, dtype=torch.int64, device=dev)
    while True:
        before = lbl
        for _ in range(LABEL_CHUNK):
            padded = torch.cat([lbl, sent], dim=1)
            nl = torch.where(link, padded[:, nb], SENTINEL).amin(dim=2)
            lbl = torch.minimum(lbl, nl)
            lbl = torch.cat([lbl, sent], dim=1).gather(1, lbl)
        min_labels.sweeps += LABEL_CHUNK
        if torch.equal(lbl, before):
            return lbl


min_labels.sweeps = 0


def compute_chains(stones: torch.Tensor) -> torch.Tensor:
    """Chain ids (min-point-index rep) from raw stones [B, 361] by label
    propagation (`min_labels`). Only for board construction; moves keep
    `chain_id` incrementally."""
    occupied = stones != EMPTY
    same = (_nbr(_pad(stones, 99)) == stones[:, :, None]) & occupied[:, :, None]
    return torch.where(occupied, min_labels(occupied, same), -1).to(torch.int32)


def new_state(batch_size: int, komi: Union[float, torch.Tensor] = DEFAULT_KOMI,
              device="cuda", history: int = MAX_HISTORY) -> GoState:
    """B empty boards with black to move."""
    B = batch_size
    dev = torch.device(device)
    i32 = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
    stones = torch.zeros((B, NUM_LOCS), dtype=torch.int8, device=dev)
    h = compute_hash(stones)
    hist = torch.zeros((B, history, 2), dtype=torch.int64, device=dev)
    if history > 0:
        hist[:, 0] = h
    komi_t = torch.as_tensor(komi, dtype=torch.float32, device=dev)
    return GoState(
        stones=stones,
        chain_id=torch.full((B, NUM_LOCS), -1, dtype=torch.int32, device=dev),
        hash=h,
        history=hist,
        history_len=i32(1),
        last_moves=torch.full((B, NUM_LAST_MOVES), NOOP_MOVE,
                              dtype=torch.int32, device=dev),
        to_move=torch.full((B,), BLACK, dtype=torch.int8, device=dev),
        ko_point=i32(-1),
        consecutive_passes=i32(0),
        passes=i32(0),
        move_count=i32(0),
        komi=torch.broadcast_to(komi_t, (B,)).clone(),
        num_b_prisoners=i32(0),
        num_w_prisoners=i32(0),
        pass_alive=torch.zeros((B, NUM_LOCS), dtype=torch.int8, device=dev),
        pa_move=i32(0),
    )


def from_stones(stones, komi: Union[float, torch.Tensor] = DEFAULT_KOMI,
                to_move: Union[int, torch.Tensor] = BLACK, device="cuda",
                history: int = MAX_HISTORY) -> GoState:
    """B positions from raw stone arrays [B, 361] (position only: chains
    recomputed, history row 0 = the position's hash, no last moves).
    `komi` and `to_move` are scalars or [B] (board.py:228-242 of the JAX
    package, vmapped)."""
    dev = torch.device(device)
    stones = torch.as_tensor(stones).to(device=dev, dtype=torch.int8)
    B = stones.shape[0]
    st = new_state(B, komi, device=dev, history=history)
    h = compute_hash(stones)
    hist = torch.zeros_like(st.history)
    if history > 0:
        hist[:, 0] = h
    color = torch.as_tensor(to_move, device=dev).to(torch.int8)
    return st._replace(stones=stones, chain_id=compute_chains(stones), hash=h,
                       history=hist,
                       to_move=torch.broadcast_to(color, (B,)).clone())


class PlaySim(NamedTuple):
    stones: torch.Tensor  # int8[B, 361] after placement + captures
    chain_id: torch.Tensor  # int32[B, 361]
    new_rep: torch.Tensor  # int64[B]
    captured_mask: torch.Tensor  # bool[B, 361]
    num_captured: torch.Tensor  # int32[B]
    own_libs: torch.Tensor  # int32[B]
    occupied: torch.Tensor  # bool[B]
    suicide: torch.Tensor  # bool[B]
    new_hash: torch.Tensor  # int64[B, 2]


def _libs_of(chain_arr: torch.Tensor, empty_mask: torch.Tensor,
             reps: torch.Tensor) -> torch.Tensor:
    """Liberties of chains `reps` [B, R] -> int32[B, R] by dilate-and-count."""
    m = chain_arr[:, None, :] == reps[:, :, None]  # [B, R, 361]
    B, R, _ = m.shape
    mp = torch.cat([m, torch.zeros((B, R, 1), dtype=torch.bool,
                                   device=m.device)], dim=2)
    dil = mp[:, :, NEIGHBORS.on(m.device)].any(dim=3)  # [B, R, 361]
    return (dil & empty_mask[:, None, :]).sum(dim=2, dtype=torch.int32)


def simulate_play(stones: torch.Tensor, chain_id: torch.Tensor,
                  base_hash: torch.Tensor, p: torch.Tensor,
                  c: torch.Tensor) -> PlaySim:
    """Resolve a stone of colour c [B] at point p [B] (0..360): merge,
    captures, suicide, new hash. Dry-run core of `step` (PlayMoveDry
    semantics, board.cc:595-644)."""
    dev = stones.device
    B = stones.shape[0]
    b = torch.arange(B, device=dev)
    p = p.long()
    c8 = c.to(torch.int8)
    occupied = stones[b, p] != EMPTY
    stones1 = stones.clone()
    stones1[b, p] = c8

    nbrs = NEIGHBORS.on(dev)[p]  # [B, 4]
    nbr_color = _pad(stones, 99).gather(1, nbrs)
    nbr_chain = _pad(chain_id, -1).gather(1, nbrs)

    friendly = nbr_color == c8[:, None]
    fr = torch.where(friendly, nbr_chain, torch.full_like(nbr_chain, NUM_LOCS))
    new_rep = torch.minimum(p, fr.min(dim=1).values.long())
    chain1 = chain_id.clone()
    chain1[b, p] = p.to(torch.int32)
    iota = torch.arange(NUM_LOCS, device=dev)[None]
    merge = (chain1[:, :, None] == fr[:, None, :]).any(dim=2) | (iota == p[:, None])
    chain1 = torch.where(merge, new_rep[:, None].to(torch.int32), chain1)

    empty1 = stones1 == EMPTY
    oppm = nbr_color == -c8[:, None]
    opp_rep = torch.where(oppm, nbr_chain, torch.full_like(nbr_chain, -1))
    cap = oppm & (opp_rep >= 0) & (_libs_of(chain1, empty1, opp_rep) == 0)
    captured_mask = ((chain1[:, :, None] == opp_rep[:, None, :])
                     & cap[:, None, :]).any(dim=2)
    num_captured = captured_mask.sum(dim=1, dtype=torch.int32)
    stones2 = torch.where(captured_mask, torch.zeros_like(stones1), stones1)
    chain2 = torch.where(captured_mask, torch.full_like(chain1, -1), chain1)

    own_libs = _libs_of(chain2, stones2 == EMPTY, new_rep[:, None])[:, 0]
    suicide = (own_libs == 0) & ~occupied

    # Incremental additive hash: +z[p,c] -z[p,empty]; each captured q adds
    # z[q,empty] - z[q,opp].
    z = ZOBRIST.on(dev)
    c_idx = c8.long() + 1
    opp_idx = -c8.long() + 1
    delta = z[p, c_idx] - z[p, 1]  # [B, 2]
    z_all = z[:NUM_LOCS]  # [361, 3, 2]
    pts = torch.arange(NUM_LOCS, device=dev)
    cap_terms = z_all[:, 1, :][None] - z_all[pts[None, :], opp_idx[:, None]]
    cap_delta = torch.where(captured_mask[:, :, None], cap_terms,
                            torch.zeros_like(cap_terms)).sum(dim=1)
    new_hash = (base_hash + delta + cap_delta) & HASH_MASK

    return PlaySim(stones2, chain2, new_rep, captured_mask, num_captured,
                   own_libs, occupied, suicide, new_hash)


def in_history(state: GoState, h: torch.Tensor) -> torch.Tensor:
    """Exact positional-superko membership of hashes h [B, 2] -> bool[B].
    A zero-capacity history (search scratch states) disables the check."""
    cap = state.history.shape[1]
    if cap == 0:
        return torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    valid = torch.arange(cap, device=h.device)[None] < state.history_len[:, None]
    eq = (state.history == h[:, None, :]).all(dim=2) & valid
    return eq.any(dim=1)


def strip_history(state: GoState) -> GoState:
    """Zero-capacity-history view for in-tree search scratch boards
    (board.py:335-350 of the JAX package): the tree search never checks
    positional superko on simulated moves, so the [B, H, 2] ring is
    dropped, and `step` then skips its superko bookkeeping."""
    return state._replace(history=state.history[:, :0])


def _move_status(is_pass, occupied, pa_banned, suicide, superko) -> torch.Tensor:
    """Move status codes, first cause first: pass (and out of bounds) is
    valid, then occupied, pass-alive region, self-capture, positional
    superko (board.py:497-513 of the JAX package)."""
    status = torch.full_like(occupied, MOVE_VALID, dtype=torch.int32)
    status = torch.where(superko, MOVE_REPEATED_POSITION, status)
    status = torch.where(suicide, MOVE_SELF_CAPTURE, status)
    status = torch.where(pa_banned, MOVE_PASS_ALIVE_REGION, status)
    status = torch.where(occupied, MOVE_LOC_NOT_EMPTY, status)
    return torch.where(is_pass, MOVE_VALID, status).to(torch.int32)


def step(state: GoState, action: torch.Tensor) -> Tuple[GoState, torch.Tensor]:
    """Play `action` [B] (0..360 point, 361 pass) for each board's to_move.

    Returns (new_state, status int32[B]). An illegal action leaves the board
    unchanged and is recorded as a pass (board.py:357 semantics).
    """
    dev = state.stones.device
    B = state.stones.shape[0]
    b = torch.arange(B, device=dev)
    action = action.long()
    c = state.to_move
    in_bounds = (action >= 0) & (action < NUM_LOCS)
    p = action.clamp(0, NUM_LOCS - 1)
    is_pass = ~in_bounds

    sim = simulate_play(state.stones, state.chain_id, state.hash, p, c)
    superko = in_history(state, sim.new_hash)
    pa_banned = state.pass_alive[b, p] != EMPTY
    illegal = (sim.occupied | sim.suicide | superko | pa_banned) & ~is_pass
    do_play = ~is_pass & ~illegal

    status = _move_status(is_pass, sim.occupied, pa_banned, sim.suicide, superko)

    dp = do_play[:, None]
    stones_f = torch.where(dp, sim.stones, state.stones)
    chain_f = torch.where(dp, sim.chain_id, state.chain_id)
    hash_f = torch.where(dp, sim.new_hash, state.hash)
    hist_cap = state.history.shape[1]
    history_f = state.history
    if hist_cap > 0:
        hist_idx = state.history_len.long().clamp(0, hist_cap - 1)
        history_f = state.history.clone()
        old = history_f[b, hist_idx]
        history_f[b, hist_idx] = torch.where(dp, sim.new_hash, old)
    history_len_f = state.history_len + do_play.to(torch.int32)

    # Simple-ko point: exactly one stone captured by a new single-stone
    # chain that itself has exactly one liberty.
    own_size = (sim.chain_id == sim.new_rep[:, None].to(torch.int32)).sum(
        dim=1, dtype=torch.int32)
    captured_idx = sim.captured_mask.to(torch.uint8).argmax(dim=1).to(torch.int32)
    new_ko = torch.where(
        do_play & (sim.num_captured == 1) & (own_size == 1) & (sim.own_libs == 1),
        captured_idx, torch.full_like(captured_idx, -1))

    effective_pass = is_pass | illegal
    move_rec = torch.where(do_play, p, torch.full_like(p, PASS_MOVE)).to(torch.int32)
    last_moves_f = torch.cat([state.last_moves[:, 1:], move_rec[:, None]], dim=1)

    zero = torch.zeros_like(sim.num_captured)
    cap_b = torch.where(c == WHITE, sim.num_captured, zero)
    cap_w = torch.where(c == BLACK, sim.num_captured, zero)
    played = do_play.to(torch.int32)

    new_st = GoState(
        stones=stones_f,
        chain_id=chain_f,
        hash=hash_f,
        history=history_f,
        history_len=history_len_f,
        last_moves=last_moves_f,
        to_move=(-c).to(torch.int8),
        ko_point=new_ko,
        consecutive_passes=torch.where(effective_pass,
                                       state.consecutive_passes + 1,
                                       torch.zeros_like(state.consecutive_passes)),
        passes=state.passes + effective_pass.to(torch.int32),
        move_count=state.move_count + 1,
        komi=state.komi,
        num_b_prisoners=state.num_b_prisoners + played * cap_b,
        num_w_prisoners=state.num_w_prisoners + played * cap_w,
        pass_alive=state.pass_alive,
        pa_move=state.pa_move,
    )
    return new_st, status


def is_game_over(state: GoState) -> torch.Tensor:
    """Two consecutive passes end the game (board.cc:524) -> bool[B]."""
    return state.consecutive_passes >= 2


def legal_mask_from_libs(state: GoState, libs_pt: torch.Tensor) -> torch.Tensor:
    """Cheap legality mask [B, 362] from per-point chain liberties [B, 361]:
    empty, not suicide, not the simple-ko point, not pass-alive; pass always
    legal. Positional superko beyond simple ko is left to `step` /
    `superko_violation` on the played move (a documented deviation)."""
    c = state.to_move[:, None, None]
    nbr_color = _nbr(_pad(state.stones, 99))  # [B, 361, 4]
    nbr_libs = _nbr(_pad(libs_pt, 0))
    empty = state.stones == EMPTY
    any_empty_nbr = (nbr_color == EMPTY).any(dim=2)
    safe_friend = ((nbr_color == c) & (nbr_libs >= 2)).any(dim=2)
    captures = ((nbr_color == -c) & (nbr_libs == 1)).any(dim=2)
    legal = empty & (any_empty_nbr | safe_friend | captures)
    iota = torch.arange(NUM_LOCS, device=state.stones.device)[None]
    legal = legal & (iota != state.ko_point[:, None])
    legal = legal & (state.pass_alive == EMPTY)
    ones = torch.ones((legal.shape[0], 1), dtype=torch.bool, device=legal.device)
    return torch.cat([legal, ones], dim=1)


def legal_mask_batch(states: GoState) -> torch.Tensor:
    """Batched cheap legality mask [B, 362], liberties from the kernel."""
    from p3achygo_tpu_torch.ops.liberties import point_liberties_batch

    libs = point_liberties_batch(states.stones, states.chain_id)
    return legal_mask_from_libs(states, libs)


def superko_violation(state: GoState, action: torch.Tensor) -> torch.Tensor:
    """Would playing `action` [B] repeat a previous position? -> bool[B]."""
    action = action.long()
    in_bounds = (action >= 0) & (action < NUM_LOCS)
    p = action.clamp(0, NUM_LOCS - 1)
    sim = simulate_play(state.stones, state.chain_id, state.hash, p,
                        state.to_move)
    return in_bounds & ~sim.occupied & ~sim.suicide & in_history(state,
                                                                 sim.new_hash)


def _dry_run(state: GoState, actions: torch.Tensor) -> torch.Tensor:
    """Exact statuses of M candidate actions per board, actions [B, M] ->
    int32[B, M]: one `simulate_play` over the B*M lanes, each lane a copy of
    its board, and positional superko against each board's history."""
    B, M = actions.shape
    actions = actions.long()
    in_bounds = (actions >= 0) & (actions < NUM_LOCS)
    p = actions.clamp(0, NUM_LOCS - 1)
    lanes = lambda x: x[:, None].expand(B, M, *x.shape[1:]).reshape(B * M, *x.shape[1:])
    sim = simulate_play(lanes(state.stones), lanes(state.chain_id),
                        lanes(state.hash), p.reshape(-1), lanes(state.to_move))
    cap = state.history.shape[1]
    if cap == 0:
        superko = torch.zeros_like(in_bounds)
    else:
        valid = torch.arange(cap, device=p.device)[None] < state.history_len[:, None]
        new_hash = sim.new_hash.reshape(B, M, 1, 2)
        eq = (state.history[:, None] == new_hash).all(dim=3) & valid[:, None]
        superko = eq.any(dim=2)
    pa_banned = state.pass_alive.gather(1, p) != EMPTY
    return _move_status(~in_bounds, sim.occupied.reshape(B, M), pa_banned,
                        sim.suicide.reshape(B, M), superko)


def dry_run_status(state: GoState, action: torch.Tensor) -> torch.Tensor:
    """Exact status of `action` [B] for each board's to_move, positional
    superko included -> int32[B] (board.py:491-513 of the JAX package,
    batch-first). Out-of-bounds actions are passes, hence valid."""
    return _dry_run(state, action.reshape(-1, 1))[:, 0]


def full_legal_mask(state: GoState) -> torch.Tensor:
    """Exact legality of all 362 actions, positional superko included ->
    bool[B, 362] (board.py:516-523 of the JAX package): the 361 points in
    one dry run over B*361 lanes, then the pass, always legal. About 361
    times the work of `legal_mask_batch`; for GTP, analysis and tests."""
    B = state.stones.shape[0]
    pts = torch.arange(NUM_LOCS, device=state.stones.device).expand(B, NUM_LOCS)
    legal = _dry_run(state, pts) == MOVE_VALID
    return torch.cat([legal, torch.ones((B, 1), dtype=torch.bool,
                                        device=legal.device)], dim=1)
