"""Cur-vs-cand evaluation harness (port of p3achygo_tpu/eval/harness.py;
replaces the reference's cc/eval/, ~1,500 LoC C++).

All games run in lockstep on one device:

- Board i < B/2 gives the candidate Black; i >= B/2 gives it White
  (color alternation by game parity, eval.cc:110).
- Because pass is a move, to_move is identical across the lockstep batch
  at every ply, so each ply needs the candidate net for exactly one half
  of the batch and the incumbent for the other: the eval_fn evaluates each
  contiguous half with its model and concatenates. Weights are modules
  here: `EvalRunner.run(cand, cur)` takes the two networks.
- Per-player search configs (player_config.h:21-109). When the two
  players' configs are identical the whole batch searches as one call;
  otherwise each half runs its active player's search, Gumbel
  (mcts/gumbel.py, with MCGS or the integral score utility if its config
  asks) or PUCT (mcts/puct.py).
- Per-player tree reuse across plies (eval.cc:125-141, :330-358): each
  board keeps one tree per COLOR; after every move BOTH trees advance to
  the played move's child by subtree compaction. PUCT players carry no
  tree (search_root_puct has no init_tree path), as in the JAX package;
  under MCGS a compaction keeps what the JAX one keeps, the nodes whose
  first allocation parent is kept (tree._compact).
- Resign at root OUTCOME value < -0.92 (kResignThreshold eval.cc:28,
  checked as VOutcome(player_tree), eval.cc:278-283).
- Result: winrate -> relative Elo +- 95% CI (eval/main.cc:455-470).

Random draws (the search's Gumbel noise) come from the `generator`
argument.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from p3achygo_tpu_torch.constants import BLACK, MAX_GAME_LEN, PASS_MOVE, WHITE
from p3achygo_tpu_torch.eval.elo import elo_with_ci
from p3achygo_tpu_torch.eval.player_config import PlayerSearchConfig
from p3achygo_tpu_torch.game.board import (
    is_game_over,
    map_state,
    new_state,
    select_state,
    step,
    superko_violation,
)
from p3achygo_tpu_torch.game.scoring import score as score_board
from p3achygo_tpu_torch.mcts.gumbel import EvalFn, EvalOutput, SearchParams, make_eval_fn, search_root
from p3achygo_tpu_torch.mcts.puct import search_root_puct
from p3achygo_tpu_torch.mcts.tree import compact_subtree, make_tree


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    num_games: int = 100  # reference protocol (train_sp_eval.py:31-33)
    komi: float = 7.5
    max_game_len: int = MAX_GAME_LEN
    resign_threshold: float = -0.92
    # noise_scale 1.0 = reference gumbel semantics and the source of
    # per-game diversity: with noise 0 and tau 0 every game of a color
    # half is identical.
    search: SearchParams = dataclasses.field(
        default_factory=lambda: SearchParams(n=32, k=4, noise_scale=1.0,
                                             tau=0.0))
    # Per-player overrides (player_config.h); None -> gumbel with `search`.
    cand: Optional[PlayerSearchConfig] = None
    cur: Optional[PlayerSearchConfig] = None
    # Per-player tree reuse across plies (eval.cc:330-358 Reap).
    tree_reuse: bool = True


@dataclasses.dataclass
class EvalResult:
    cand_wins: float
    num_games: int
    winrate: float
    elo: float
    elo_lo: float
    elo_hi: float
    by_resign: int


def _cat(a, b):
    return torch.cat([a, b], dim=0)


def _half_eval_fn(eval_cand: EvalFn, eval_cur: EvalFn, cand_first: bool) -> EvalFn:
    """Evaluate the first half of the batch with one net, the second with
    the other (leaf batches are board-major, so halves stay halves)."""

    def fn(states) -> EvalOutput:
        H = states.stones.shape[0] // 2
        fa = eval_cand if cand_first else eval_cur
        fb = eval_cur if cand_first else eval_cand
        oa = fa(map_state(lambda x: x[:H], states))
        ob = fb(map_state(lambda x: x[H:], states))
        return EvalOutput(*[None if a is None else _cat(a, b) for a, b in zip(oa, ob)])

    return fn


def _player_cfg(sp: SearchParams) -> PlayerSearchConfig:
    return PlayerSearchConfig(search_type="gumbel", n=sp.n, k=sp.k,
                              tau=sp.tau, noise_scale=sp.noise_scale,
                              score_weight=sp.score_weight,
                              max_depth=sp.max_depth)


def _resolve_players(cfg: EvalConfig) -> Tuple[PlayerSearchConfig,
                                               PlayerSearchConfig]:
    cand = cfg.cand if cfg.cand is not None else _player_cfg(cfg.search)
    cur = cfg.cur if cfg.cur is not None else _player_cfg(cfg.search)
    return cand, cur


def _reuse_capacity(cfg: EvalConfig) -> int:
    """Carried-subtree capacity: covers the biggest gumbel player's n."""
    if not cfg.tree_reuse:
        return 0
    cand, cur = _resolve_players(cfg)
    ns = [p.n for p in (cand, cur) if p.search_type != "puct"]
    return (max(ns) + 2) if ns else 0


def _half_search(generator, states_h, fn_h, pcfg: PlayerSearchConfig,
                 tree_h, rcap: int):
    """Run one half's active player's search -> (result, work tree)."""
    if pcfg.search_type == "puct":
        return search_root_puct(states_h, fn_h, pcfg.to_puct_params(),
                                generator=generator), None
    sp = pcfg.to_search_params()
    if tree_h is not None:
        return search_root(states_h, fn_h, sp, generator=generator,
                           init_tree=tree_h, reuse_capacity=rcap)
    return search_root(states_h, fn_h, sp, generator=generator), None


def _eval_ply(generator, states, resigned, winner, tree_m, tree_o,
              fn_cand, fn_cur, cfg: EvalConfig, cand_first: bool):
    """One lockstep eval ply (search -> resign check -> move -> tree Reap).

    `tree_m`/`tree_o` are the mover-color / opponent-color trees (or None
    without reuse). `fn_cand`/`fn_cur` evaluate with the candidate /
    incumbent net; `cand_first` says the first half's mover is the
    candidate at this ply parity. Returns
    (states, resigned, winner, next_tree_m, next_tree_o).
    """
    B = states.stones.shape[0]
    H = B // 2
    cand_cfg, cur_cfg = _resolve_players(cfg)
    rcap = _reuse_capacity(cfg)
    first_cfg = cand_cfg if cand_first else cur_cfg
    second_cfg = cur_cfg if cand_first else cand_cfg
    fn_first = fn_cand if cand_first else fn_cur
    fn_second = fn_cur if cand_first else fn_cand

    if first_cfg == second_cfg and first_cfg.search_type != "puct":
        # Identical configs: one full-batch search (weights still routed
        # per half by _half_eval_fn).
        fn = _half_eval_fn(fn_cand, fn_cur, cand_first)
        res, work = _half_search(generator, states, fn, first_cfg, tree_m, rcap)
        works = (work,)
    else:
        halves = []
        for sl, fn_h, pcfg in ((slice(0, H), fn_first, first_cfg),
                               (slice(H, B), fn_second, second_cfg)):
            st_h = map_state(lambda x: x[sl], states)
            tr_h = (map_state(lambda x: x[sl], tree_m)
                    if tree_m is not None and pcfg.search_type != "puct" else None)
            halves.append(_half_search(generator, st_h, fn_h, pcfg, tr_h, rcap))
        res = map_state(_cat, halves[0][0], halves[1][0])
        works = (halves[0][1], halves[1][1])

    viol = superko_violation(states, res.mcts_move)
    pass_ = torch.full_like(res.mcts_move, PASS_MOVE)
    move = torch.where(viol, pass_, res.mcts_move)
    over = is_game_over(states) | resigned
    move = torch.where(over, pass_, move)

    # Resignation by the player to move on root OUTCOME value
    # (VOutcome(player_tree) < kResignThreshold, eval.cc:278-283).
    should_resign = (res.root_outcome < cfg.resign_threshold) & ~over
    new_resigned = resigned | should_resign
    winner = torch.where(should_resign & (winner == 0),
                         (-states.to_move).to(torch.int8), winner)

    new_states, _ = step(states, move)
    active = ~over & ~should_resign
    out_states = select_state(active, new_states, states)

    # Tree Reap (eval.cc:330-358): the mover's next tree comes from its
    # post-search work tree compacted under the played move; the opponent's
    # stored tree advances under the same move. Frozen boards keep trees.
    next_m, next_o = tree_m, tree_o
    if tree_m is not None:
        dev = states.stones.device
        if len(works) == 1:
            nm = (compact_subtree(works[0], move, rcap)
                  if works[0] is not None else make_tree(B, rcap, dev))
        else:
            parts = [compact_subtree(w, move[sl], rcap) if w is not None
                     else make_tree(H, rcap, dev)
                     for w, sl in zip(works, (slice(0, H), slice(H, B)))]
            nm = map_state(_cat, *parts)
        no = compact_subtree(tree_o, move, rcap)
        next_m = select_state(active, nm, tree_m)
        next_o = select_state(active, no, tree_o)

    return out_states, new_resigned, winner, next_m, next_o


def _finish(states, resigned, winner, cand_is_black) -> EvalResult:
    B = states.stones.shape[0]
    bs, ws, _ = score_board(states)
    score_winner = torch.where(bs > ws, BLACK, WHITE).to(torch.int8)
    final_winner = torch.where(winner != 0, winner, score_winner)
    cand_color = torch.where(cand_is_black, BLACK, WHITE).to(torch.int8)
    cand_wins = float((final_winner == cand_color).sum())
    elo, lo, hi = elo_with_ci(cand_wins, B)
    return EvalResult(
        cand_wins=cand_wins, num_games=B, winrate=cand_wins / B,
        elo=elo, elo_lo=lo, elo_hi=hi, by_resign=int(resigned.sum()))


def run_eval(eval_cand: EvalFn, eval_cur: EvalFn, cfg: EvalConfig,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> EvalResult:
    """Play cfg.num_games lockstep games; return the candidate's relative
    Elo."""
    B = cfg.num_games
    if B % 2:
        raise ValueError(f"num_games must be even, got {B}")
    dev = torch.device(device)
    states = new_state(B, cfg.komi, device=dev)
    cand_is_black = torch.arange(B, device=dev) < B // 2
    rcap = _reuse_capacity(cfg)
    tree_b = make_tree(B, rcap, dev) if rcap else None
    tree_w = make_tree(B, rcap, dev) if rcap else None
    resigned = torch.zeros(B, dtype=torch.bool, device=dev)
    winner = torch.zeros(B, dtype=torch.int8, device=dev)
    # Ply parity t: to_move is BLACK iff t even (lockstep invariant); the
    # first half's mover is the candidate at even plies.
    for t in range(cfg.max_game_len):
        even = t % 2 == 0
        tm, to = (tree_b, tree_w) if even else (tree_w, tree_b)
        states, resigned, winner, tm, to = _eval_ply(
            generator, states, resigned, winner, tm, to, eval_cand, eval_cur,
            cfg, cand_first=even)
        tree_b, tree_w = (tm, to) if even else (to, tm)
        if bool((is_game_over(states) | resigned).all()):
            break
    return _finish(states, resigned, winner, cand_is_black)


class EvalRunner:
    """run_eval between two networks: `run(cand, cur)` serves each with
    the plain model forward (make_eval_fn)."""

    def __init__(self, cfg: EvalConfig):
        self.cfg = cfg

    def run(self, cand, cur, generator: Optional[torch.Generator] = None
            ) -> EvalResult:
        device = next(cand.parameters()).device
        return run_eval(make_eval_fn(cand), make_eval_fn(cur), self.cfg,
                        generator=generator, device=device)


def run_eval_params(cand, cur, cfg: EvalConfig,
                    generator: Optional[torch.Generator] = None) -> EvalResult:
    """One-shot convenience wrapper over EvalRunner."""
    return EvalRunner(cfg).run(cand, cur, generator)
