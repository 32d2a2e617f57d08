"""Bounded greedy ladder reading for the laddered-stones feature planes
(port of p3achygo_tpu/game/ladder.py; the reference reads ladders with a
recursive forking solver, cc/game/board.cc:692-899 GetLadderedStones).

The JAX package's chase, batch-first:

- Candidate chains: the first `MAX_CANDIDATES` chains with 1 or 2
  liberties, in board order of their representative point.
- Chase (at most `MAX_DEPTH` iterations): the defender at 1 liberty
  captures an adjacent attacker chain in atari if it can, else extends at
  its liberty; if it cannot, the chain is laddered. At 2 liberties the
  attacker plays whichever liberty leaves the defender fewer liberties
  after its forced extension (2-ply lookahead, no forking). 0 liberties is
  captured (laddered), 3 or more is escaped.

All B*MAX_CANDIDATES chases run as one batch of boards. Each iteration
computes the defender's and the attacker's move for every lane and selects
(six `simulate_play` calls), as JAX does, so no lane takes a branch on the
host. A lane that is done keeps its carry unchanged (every update is gated
on not done), which is what JAX's vmapped `while_loop` does, so running
extra iterations changes nothing: the host reads which lanes are still
live once per `LADDER_CHUNK` iterations (one sync each, counted in
`laddered_stones.syncs`) and carries on with those lanes alone.

Labels are used as the JAX package uses them: candidates are chains whose
label equals their own point index, and a chain is followed by the label
at its representative's cell. Under a symmetry that permutes `chain_id`
without relabelling (make_eval_fn), some chains then have no candidate,
exactly as in JAX.
"""
from __future__ import annotations

import torch

from p3achygo_tpu_torch.constants import EMPTY, NUM_LOCS
from p3achygo_tpu_torch.game.board import (
    GoState,
    _nbr,
    _pad,
    chain_lib_counts,
    simulate_play,
)

MAX_CANDIDATES = 8
# A full-board zigzag ladder costs ~2 plies per diagonal step plus the
# capture tail (reference solver depth: 300, board.cc:696).
MAX_DEPTH = 96
LADDER_CHUNK = 8  # chase iterations between two reads of the live lanes


def _chain_liberty_points(stones, chain_id, rep):
    """bool[L, 361]: empty points that are liberties of chain `rep` [L]."""
    adj = _nbr(_pad(chain_id, -1))  # [L, 361, 4]
    return ((stones == EMPTY) & (adj == rep[:, None, None]).any(dim=2)
            & (rep >= 0)[:, None])


def _first_set(mask):
    """Index of the first set entry of each row of bool[L, 361], or 361."""
    iota = torch.arange(NUM_LOCS, device=mask.device)
    return torch.where(mask, iota, NUM_LOCS).amin(dim=1)


def _first_two(mask):
    """Indices of the first two set entries of each row of bool[L, 361]
    (or -1)."""
    iota = torch.arange(NUM_LOCS, device=mask.device)
    first = _first_set(mask)
    second = _first_set(mask & (iota != first[:, None]))
    to_valid = lambda v: torch.where(v < NUM_LOCS, v, -1)
    return to_valid(first), to_valid(second)


def _at(x, idx):
    """x[l, idx[l]] for x [L, 361] and idx [L]."""
    return x.gather(1, idx.long()[:, None])[:, 0]


def _defender_libs(stones, chain_id, r):
    """Liberties of chain `r` [L] (99 where r < 0)."""
    counts = chain_lib_counts(stones, chain_id)
    return torch.where(r >= 0, _at(counts, r.clamp(0, NUM_LOCS)), 99)


def _play(stones, chain_id, p, color):
    zero_hash = torch.zeros((stones.shape[0], 2), dtype=torch.int64,
                            device=stones.device)
    return simulate_play(stones, chain_id, zero_hash,
                         p.clamp(0, NUM_LOCS - 1), color)


def _pick(cond, a, b):
    return torch.where(cond.reshape(-1, *([1] * (a.dim() - 1))), a, b)


def _chase_step(st, cid, r, color, to_def, done, laddered):
    """One iteration of the JAX chase body (ladder.py:73-177) on every lane."""
    counts_all = chain_lib_counts(st, cid)
    libs = torch.where(r >= 0, _at(counts_all, r.clamp(0, NUM_LOCS)), 99)

    # Counter-atari: an attacker chain next to the defender and in atari
    # is captured instead of extending.
    chain_mask = (cid == r[:, None]) & (r >= 0)[:, None]
    nbr_in_chain = _nbr(_pad(chain_mask, False)).any(dim=2)
    cid_libs = counts_all.gather(1, cid.long().clamp(0, NUM_LOCS))
    opp_atari_adj = (st == (-color)[:, None]) & nbr_in_chain & (cid_libs == 1)
    counter_atari = opp_atari_adj.any(dim=1)
    cap_cell = _first_set(opp_atari_adj) % NUM_LOCS  # argmax: 0 when none
    cap_rep = _at(cid, cap_cell)
    cap_pt, _ = _first_two(_chain_liberty_points(st, cid, cap_rep))

    captured = libs == 0
    escaped = libs >= 3
    laddered = laddered | (captured & ~done)
    done = done | captured | escaped

    lib1, lib2 = _first_two(_chain_liberty_points(st, cid, r))

    # The defender's move: capture, else extend.
    sim_cap = _play(st, cid, cap_pt, color)
    cap_ok = counter_atari & (cap_pt >= 0) & ~sim_cap.suicide & ~sim_cap.occupied
    sim_ext = _play(st, cid, lib1, color)
    ext_ok = (lib1 >= 0) & ~sim_ext.suicide
    d_st = _pick(cap_ok, sim_cap.stones, sim_ext.stones)
    d_cid = _pick(cap_ok, sim_cap.chain_id, sim_ext.chain_id)
    # The rep cell stays inside the (possibly merged) chain.
    d_r = _at(d_cid, r.clamp(0, NUM_LOCS - 1)).long()
    d_ok = cap_ok | ext_ok

    # The attacker's move: rank both liberties by the defender's liberties
    # after the attacker's stone and the defender's forced extension.
    att = -color

    def try_at(lib):
        sim = _play(st, cid, lib, att)
        libs_after = _defender_libs(sim.stones, sim.chain_id, r)
        ok = (lib >= 0) & ~sim.suicide & ~sim.occupied
        dlib, _ = _first_two(_chain_liberty_points(sim.stones, sim.chain_id, r))
        dsim = _play(sim.stones, sim.chain_id, dlib, color)
        d_rep = _at(dsim.chain_id, dlib.clamp(0, NUM_LOCS - 1)).long()
        libs2 = torch.where((dlib >= 0) & ~dsim.suicide,
                            _defender_libs(dsim.stones, dsim.chain_id, d_rep), 0)
        sc = torch.where(libs_after >= 2, 1000 + libs_after, libs2)
        return sim, torch.where(ok, sc, 9999), ok

    sim1, s1, ok1 = try_at(lib1)
    sim2, s2, ok2 = try_at(lib2)
    use1 = s1 <= s2
    a_st = _pick(use1, sim1.stones, sim2.stones)
    a_cid = _pick(use1, sim1.chain_id, sim2.chain_id)
    a_ok = torch.where(use1, ok1, ok2)

    at_def = to_def & (libs == 1)
    at_att = ~to_def & (libs == 2)
    # Not covered by the chase: the attacker to move at 1 liberty captures
    # (laddered); the defender to move at 2 liberties is not forced (escape).
    attacker_captures = ~to_def & (libs == 1)
    laddered = laddered | (attacker_captures & ~done)
    done = done | attacker_captures | (to_def & (libs == 2))
    laddered = laddered | (at_def & ~d_ok & ~done)
    done = done | (at_def & ~d_ok) | (at_att & ~a_ok)

    take_def = at_def & d_ok & ~done
    take_att = at_att & a_ok & ~done
    st = _pick(take_def, d_st, _pick(take_att, a_st, st))
    cid = _pick(take_def, d_cid, _pick(take_att, a_cid, cid))
    r = torch.where(take_def, d_r, r)
    to_def = torch.where(take_def | take_att, ~to_def, to_def)
    return st, cid, r, to_def, done, laddered


def _chase(stones, chain_id, rep, color):
    """bool[L]: chain `rep` [L] (defender colour `color` [L]) is captured in
    the greedy ladder chase on its board [L, 361]."""
    libs0 = _defender_libs(stones, chain_id, rep)
    done = (rep < 0) | (libs0 >= 3)
    laddered = torch.zeros_like(done)
    live = torch.arange(rep.shape[0], device=rep.device)
    carry = (stones, chain_id, rep, color, libs0 == 1)
    for start in range(0, MAX_DEPTH, LADDER_CHUNK):
        keep = (~done[live]).nonzero()[:, 0]  # the chunk's one host sync
        laddered_stones.syncs += 1
        if keep.numel() == 0:
            break
        live, carry = live[keep], tuple(x[keep] for x in carry)
        st, cid, r, color, to_def = carry
        d, lad = done[live], laddered[live]
        for _ in range(min(LADDER_CHUNK, MAX_DEPTH - start)):
            st, cid, r, to_def, d, lad = _chase_step(st, cid, r, color, to_def,
                                                     d, lad)
        carry = (st, cid, r, color, to_def)
        done[live], laddered[live] = d, lad
    return laddered


def laddered_stones(state: GoState) -> torch.Tensor:
    """bool[B, 361]: stones of chains capturable in the greedy ladder chase
    (ladder.py:187-213 of the JAX package)."""
    stones, chain_id = state.stones, state.chain_id
    B = stones.shape[0]
    dev = stones.device
    iota = torch.arange(NUM_LOCS, device=dev)
    counts = chain_lib_counts(stones, chain_id)
    cl = counts.gather(1, chain_id.long().clamp(0, NUM_LOCS))
    cand = (chain_id == iota) & (stones != EMPTY) & ((cl == 1) | (cl == 2))
    # The first MAX_CANDIDATES candidate reps in board order.
    reps = torch.where(cand, iota, NUM_LOCS).sort(dim=1).values[:, :MAX_CANDIDATES]
    reps = torch.where(reps < NUM_LOCS, reps, -1)  # [B, K]
    colors = torch.where(reps >= 0, stones.gather(1, reps.clamp(0, NUM_LOCS - 1)),
                         0).to(torch.int8)

    K = MAX_CANDIDATES
    lanes = lambda x: x[:, None].expand(B, K, NUM_LOCS).reshape(B * K, NUM_LOCS)
    laddered = _chase(lanes(stones), lanes(chain_id), reps.reshape(-1),
                      colors.reshape(-1)).reshape(B, K) & (reps >= 0)
    hit = (chain_id[:, :, None] == reps[:, None, :]) & laddered[:, None, :]
    return hit.any(dim=2)


laddered_stones.syncs = 0
