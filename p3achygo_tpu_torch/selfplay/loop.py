"""Lockstep self-play step (port of p3achygo_tpu/selfplay/loop.py;
reference cc/selfplay/self_play_thread.cc Run :309-920).

A batch of B games advances one move per `selfplay_step_tiered` call:
per-board playout-cap randomization into a selected tier and a fast tier
(self_play_thread.cc:544-548), Gumbel search per tier at its own width,
raw-policy openings, the exact superko guard on the played move, record
writes into the `GameBuffer`, board step and tree reuse. `selfplay_step`
is the single-tier step (one search width for the batch, the whole step a
selected or a fast one), which rl/slice.py drives. Finished games are
scored by `final_scores` and replaced by `reset_finished`.

With `tier_groups` G > 1 the tier draw is independent per group of B/G
consecutive boards, and every gather and scatter of the tiered step stays
within a group. The value-bias table (mcts/bias.py) rides along the
tiered step and `reset_finished` when one is given.

Every random draw comes from the `generator` argument, or from a
`StepDraws` / `SelfplayDraws` built beforehand, so tests can inject the JAX
draws: the tier permutation uniforms (loop.py:416), the search Gumbels,
the raw-policy Gumbels of `_choose_move` (loop.py:200; JAX's `categorical`
is Gumbel-max) and the trainable-coin uniforms (loop.py:345, :499).

The step updates `buf` in place and returns it; states, aux and trees are
new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from p3achygo_tpu_torch.constants import MAX_GAME_LEN, NUM_LAST_MOVES, NUM_LOCS, NUM_MOVES, PASS_MOVE
from p3achygo_tpu_torch.game.board import (
    GoState,
    is_game_over,
    map_state,
    new_state,
    select_state,
    step,
    superko_violation,
)
from p3achygo_tpu_torch.game.scoring import score as score_board
from p3achygo_tpu_torch.mcts.gumbel import (
    EvalFn,
    RootPreStats,
    SearchParams,
    gumbel,
    root_pre_stats,
    search_root,
)
from p3achygo_tpu_torch.mcts.bias import BiasTable, make_bias_table
from p3achygo_tpu_torch.mcts.tree import Tree, compact_subtree, make_tree
from p3achygo_tpu_torch.selfplay.move_sel import compute_move_sel, default_calibration


@dataclasses.dataclass(frozen=True)
class SelfplayConfig:
    """The JAX package's SelfplayConfig fields and defaults."""

    batch_size: int = 64
    komi: float = 7.5
    max_game_len: int = MAX_GAME_LEN
    selected_n: int = 32
    selected_k: int = 4
    fast_n: int = 16
    fast_k: int = 4
    trainable_move_prob: float = 0.25
    tau_initial: float = 0.8
    tau_min: float = 0.2
    tau_half_life: int = 19
    noise_scale: float = 1.0
    disable_pass_initial_moves: int = 0
    max_raw_policy_moves: int = 30
    tree_reuse: bool = True
    sel_mult_scale_factor: float = 1.0
    tier_groups: int = 1


class GameBuffer(NamedTuple):
    """Per-move records of in-flight games [B, T, ...]."""

    stones: torch.Tensor  # int8[B, T, 361] position before the move
    last_moves: torch.Tensor  # int16[B, T, 5]
    to_move: torch.Tensor  # int8[B, T]
    pi: torch.Tensor  # f32[B, T, 362] improved policy
    move: torch.Tensor  # int16[B, T]
    root_q_outcome: torch.Tensor  # f32[B, T]
    root_score: torch.Tensor  # f32[B, T]
    kld: torch.Tensor  # f32[B, T]
    trainable: torch.Tensor  # bool[B, T]
    visits: torch.Tensor  # int32[B, T]
    mcts_value_dist: torch.Tensor  # int16[B, T, 51]
    sampled_raw: torch.Tensor  # bool[B, T]
    nn_q: torch.Tensor  # f32[B, T]
    mcts_q: torch.Tensor  # f32[B, T]
    nn_mcts_diff: torch.Tensor  # f32[B, T]
    v_stddev: torch.Tensor  # f32[B, T]
    prior_entropy: torch.Tensor  # f32[B, T]
    nn_uncertainty: torch.Tensor  # f32[B, T]
    pre_kld: torch.Tensor  # f32[B, T]
    sel_mult_modifier: torch.Tensor  # f32[B, T]
    sel_weight: torch.Tensor  # f32[B, T]
    visit_count_pre: torch.Tensor  # f32[B, T]


def make_game_buffer(B: int, T: int, device="cuda") -> GameBuffer:
    dev = torch.device(device)
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype,
                                                        device=dev)
    return GameBuffer(
        stones=z(B, T, NUM_LOCS, dtype=torch.int8),
        last_moves=z(B, T, NUM_LAST_MOVES, dtype=torch.int16),
        to_move=z(B, T, dtype=torch.int8),
        pi=z(B, T, NUM_MOVES),
        move=z(B, T, dtype=torch.int16),
        root_q_outcome=z(B, T), root_score=z(B, T), kld=z(B, T),
        trainable=z(B, T, dtype=torch.bool),
        visits=z(B, T, dtype=torch.int32),
        mcts_value_dist=z(B, T, 51, dtype=torch.int16),
        sampled_raw=z(B, T, dtype=torch.bool),
        nn_q=z(B, T), mcts_q=z(B, T), nn_mcts_diff=z(B, T), v_stddev=z(B, T),
        prior_entropy=z(B, T), nn_uncertainty=z(B, T), pre_kld=z(B, T),
        sel_mult_modifier=z(B, T), sel_weight=z(B, T), visit_count_pre=z(B, T),
    )


class SelfplayAux(NamedTuple):
    """Per-board loop state beyond the position."""

    raw_until: torch.Tensor  # int32[B]: sample raw policy while move < this
    down_bad_count: torch.Tensor  # int32[B]
    force_sel: torch.Tensor  # bool[B]


def make_aux(B: int, generator: Optional[torch.Generator] = None,
             max_raw_moves: int = 30, device="cuda",
             raw_until: Optional[torch.Tensor] = None) -> SelfplayAux:
    """Fresh-game aux: raw-policy opening length ~ U{0..max_raw_moves}
    (self_play_thread.cc:362-368), drawn from `generator` unless given."""
    dev = torch.device(device)
    if raw_until is None:
        raw_until = torch.randint(0, max_raw_moves + 1, (B,), generator=generator,
                                  device=dev)
    return SelfplayAux(
        raw_until=raw_until.to(device=dev, dtype=torch.int32),
        down_bad_count=torch.zeros(B, dtype=torch.int32, device=dev),
        force_sel=torch.zeros(B, dtype=torch.bool, device=dev),
    )


def tau_schedule(move_count: torch.Tensor, cfg: SelfplayConfig) -> torch.Tensor:
    decay = 0.5 ** (move_count.float() / cfg.tau_half_life)
    return torch.clamp(cfg.tau_initial * decay, min=cfg.tau_min)


DOWN_BAD_THRESHOLD = 0.90  # kDownBadThreshold (self_play_thread.cc:68)
DOWN_BAD_MOVES = 5  # kNumDownBadMovesThreshold


def _zero_pre_stats(B: int, device) -> RootPreStats:
    z = torch.zeros(B, dtype=torch.float32, device=device)
    return RootPreStats(n_pre=torch.zeros(B, dtype=torch.int32, device=device),
                        q_pre=z, qz_pre=z, std_pre=z, pre_kld=z, nn_q=z,
                        qz_nn=z, nn_mcts_diff=z, q_canonical=z,
                        nn_uncertainty=z, prior_entropy=z)


def tier_groups(B: int, cfg: SelfplayConfig) -> int:
    """The number G of tier groups of a B-board step (B % G == 0, at least
    two boards, one per tier, in each group)."""
    G = max(1, min(cfg.tier_groups, B))
    if B % G:
        raise ValueError(f"tier_groups={G} does not divide the batch of {B}")
    if B // G < 2:
        raise ValueError(f"tier_groups={G} leaves {B // G} board(s) per group; "
                         "need >= 2 (one per tier)")
    return G


def tier_sizes(B: int, cfg: SelfplayConfig):
    """(selected, fast) sub-batch sizes of one step: round(B/G * p) selected
    boards per group, at least one of each tier, times G groups."""
    G = tier_groups(B, cfg)
    Bg = B // G
    b_sel_g = min(max(int(round(Bg * cfg.trainable_move_prob)), 1), Bg - 1)
    return b_sel_g * G, B - b_sel_g * G


class StepDraws(NamedTuple):
    """Every random draw of one `selfplay_step_tiered` call."""

    perm_u: torch.Tensor  # f32[B] tier permutation keys
    sel_noise: torch.Tensor  # f32[B_sel, 362] root Gumbel noise
    sel_sample: torch.Tensor  # f32[B_sel, 362] tau-sampling Gumbels
    fast_noise: torch.Tensor  # f32[B_fast, 362]
    fast_sample: torch.Tensor  # f32[B_fast, 362]
    sel_raw: torch.Tensor  # f32[B_sel, 362] raw-policy sampling Gumbels
    fast_raw: torch.Tensor  # f32[B_fast, 362]
    train_u: torch.Tensor  # f32[B] trainable coins


def draw_step(B: int, cfg: SelfplayConfig, generator: torch.Generator,
              device) -> StepDraws:
    b_sel, b_fast = tier_sizes(B, cfg)
    u = lambda n: torch.rand(n, generator=generator, device=device)
    g = lambda n: gumbel((n, NUM_MOVES), generator, device)
    return StepDraws(perm_u=u(B), sel_noise=g(b_sel), sel_sample=g(b_sel),
                     fast_noise=g(b_fast), fast_sample=g(b_fast),
                     sel_raw=g(b_sel), fast_raw=g(b_fast), train_u=u(B))


def _choose_move(states: GoState, res, raw_until: torch.Tensor,
                 raw_gumbel: torch.Tensor):
    """Post-search move choice: exact superko guard on the sampled move
    (fallback: improved-policy argmax, then pass); raw-policy openings
    sample the masked prior (self_play_thread.cc:362-368, 527-533).
    Returns (move int64[B], sampling_raw, over)."""
    B = states.stones.shape[0]
    b = torch.arange(B, device=states.stones.device)
    viol = superko_violation(states, res.mcts_move)
    pi_alt = res.pi_improved.clone()
    pi_alt[b, res.mcts_move.clamp(0, NUM_MOVES - 1)] = -1.0
    alt = pi_alt.argmax(dim=-1)
    alt_viol = superko_violation(states, alt)
    pass_ = torch.full_like(alt, PASS_MOVE)
    move = torch.where(viol, torch.where(alt_viol, pass_, alt), res.mcts_move)
    sampling_raw = states.move_count < raw_until
    raw_sample = (raw_gumbel + torch.log(res.root_priors.clamp(min=1e-30))).argmax(dim=-1)
    raw_sample = torch.where(superko_violation(states, raw_sample), pass_, raw_sample)
    move = torch.where(sampling_raw, raw_sample, move)
    over = is_game_over(states)
    move = torch.where(over, pass_, move)
    return move, sampling_raw, over


def _selection_state(res, pre: RootPreStats, aux: SelfplayAux, sampling_raw,
                     cfg: SelfplayConfig, calib, sel_mult_base):
    """Down-bad annealing + sel_mult of the training-selection probability
    (self_play_thread.cc:436-537). -> (keep_prob, sel_modifier, sel_mult,
    down_bad_count)."""
    qz = res.root_outcome
    is_bad = qz.abs() > DOWN_BAD_THRESHOLD
    down_bad_count = torch.where(is_bad, aux.down_bad_count + 1,
                                 torch.zeros_like(aux.down_bad_count))
    coeff = torch.clamp((1.0 - qz.abs()) / (1.0 - DOWN_BAD_THRESHOLD), 0, 1)
    keep_prob = torch.where(down_bad_count >= DOWN_BAD_MOVES, coeff * coeff, 1.0)
    if calib is None:
        calib = default_calibration()
    sel = compute_move_sel(pre.n_pre, pre.std_pre, pre.pre_kld,
                           pre.nn_mcts_diff, pre.q_canonical,
                           cfg.sel_mult_scale_factor, calib)
    sel_modifier = torch.where(sampling_raw, 1.0, sel.modifier)
    if sel_mult_base is None:
        sel_mult = torch.ones_like(qz)
    else:
        base = torch.as_tensor(sel_mult_base, dtype=torch.float32, device=qz.device)
        sel_mult = torch.where(base > 0, base * sel_modifier, 1.0)
    return keep_prob, sel_modifier, sel_mult, down_bad_count


def _record_and_advance(states: GoState, buf: GameBuffer, res, move,
                        sampling_raw, over, pre: RootPreStats, nn_q_root,
                        nn_unc_root, trainable, keep_prob, sel_modifier,
                        cfg: SelfplayConfig):
    """Write per-move records of active boards (in place) and step."""
    B = states.stones.shape[0]
    b = torch.arange(B, device=states.stones.device)
    t = states.move_count.long().clamp(0, cfg.max_game_len - 1)
    active = ~over

    def wr(arr, val):
        old = arr[b, t]
        m = active.reshape((B,) + (1,) * (old.dim() - 1))
        arr[b, t] = torch.where(m, val.to(arr.dtype), old)

    wr(buf.stones, states.stones)
    wr(buf.last_moves, states.last_moves)
    wr(buf.to_move, states.to_move)
    wr(buf.pi, res.pi_improved)
    wr(buf.move, move)
    wr(buf.root_q_outcome, res.root_outcome)
    wr(buf.root_score, res.root_score_est)
    wr(buf.kld, res.kld)
    wr(buf.visits, res.visits)
    wr(buf.mcts_value_dist, res.root_value_dist)
    wr(buf.trainable, trainable)
    wr(buf.sampled_raw, sampling_raw)
    wr(buf.nn_q, nn_q_root)
    wr(buf.mcts_q, pre.q_pre)
    wr(buf.nn_mcts_diff, pre.nn_mcts_diff)
    wr(buf.v_stddev, pre.std_pre)
    priors = res.root_priors
    wr(buf.prior_entropy, -torch.where(priors > 0, priors * torch.log(priors + 1e-10),
                                       0.0).sum(dim=-1))
    wr(buf.nn_uncertainty, nn_unc_root)
    wr(buf.pre_kld, pre.pre_kld)
    wr(buf.sel_mult_modifier, sel_modifier)
    wr(buf.sel_weight, keep_prob)
    wr(buf.visit_count_pre, pre.n_pre.float())

    new_states, _ = step(states, move)
    # Finished boards stay frozen until reset.
    return select_state(active, new_states, states), buf


class SelfplayDraws(NamedTuple):
    """Every random draw of one `selfplay_step` call (loop.py:319: the
    search key gives `noise` and `sample`, then kraw and ksel)."""

    noise: torch.Tensor  # f32[B, 362] root Gumbel noise
    sample: torch.Tensor  # f32[B, 362] tau-sampling Gumbels
    raw: torch.Tensor  # f32[B, 362] raw-policy sampling Gumbels
    train_u: torch.Tensor  # f32[B] trainable coins


def draw_selfplay(B: int, generator: torch.Generator, device) -> SelfplayDraws:
    g = lambda: gumbel((B, NUM_MOVES), generator, device)
    return SelfplayDraws(noise=g(), sample=g(), raw=g(),
                         train_u=torch.rand(B, generator=generator, device=device))


def selfplay_step(states: GoState, buf: GameBuffer, aux: SelfplayAux,
                  eval_fn: EvalFn, params: SearchParams, cfg: SelfplayConfig,
                  selected_tier: bool,
                  generator: Optional[torch.Generator] = None,
                  reuse_tree: Optional[Tree] = None, reuse_capacity: int = 0,
                  calib=None, sel_mult_base=None,
                  draws: Optional[SelfplayDraws] = None):
    """One lockstep move for the whole batch at one search width
    (selfplay/loop.py:299-362 of the JAX package). `selected_tier` marks
    a full-search step: only its non-raw-policy, non-down-bad-suppressed
    moves become trainable records; `force_sel` boards are trainable
    whatever the tier.

    Returns (states, buf, aux, next_tree) with `reuse_tree`, else
    (states, buf, aux)."""
    B = states.stones.shape[0]
    dev = states.stones.device
    if draws is None:
        draws = draw_selfplay(B, generator, dev)
    # Pre-search root stats from the reused tree, read before the search
    # mutates the root (self_play_thread.cc:459-482).
    if reuse_tree is not None:
        pre = root_pre_stats(reuse_tree, params.c_visit, params.c_scale)
    else:
        pre = _zero_pre_stats(B, dev)

    tau = tau_schedule(states.move_count, cfg)
    if reuse_tree is not None:
        res, work_tree = search_root(states, eval_fn, params, tau=tau,
                                     init_tree=reuse_tree,
                                     reuse_capacity=reuse_capacity,
                                     gumbel_noise=draws.noise,
                                     sample_gumbel=draws.sample)
    else:
        res = search_root(states, eval_fn, params, tau=tau,
                          gumbel_noise=draws.noise, sample_gumbel=draws.sample)
        work_tree = None

    move, sampling_raw, over = _choose_move(states, res, aux.raw_until, draws.raw)
    keep_prob, sel_modifier, sel_mult, down_bad_count = _selection_state(
        res, pre, aux, sampling_raw, cfg, calib, sel_mult_base)
    coin = ~sampling_raw & (draws.train_u < keep_prob * sel_mult)
    trainable = torch.where(aux.force_sel, ~sampling_raw,
                            coin if selected_tier else torch.zeros_like(coin))

    nn_q_root = work_tree.init_util[:, 0] if work_tree is not None else pre.nn_q
    nn_unc_root = (work_tree.init_err[:, 0] if work_tree is not None
                   else pre.nn_uncertainty)
    states, buf = _record_and_advance(states, buf, res, move, sampling_raw,
                                      over, pre, nn_q_root, nn_unc_root,
                                      trainable, keep_prob, sel_modifier, cfg)
    aux = SelfplayAux(raw_until=aux.raw_until, down_bad_count=down_bad_count,
                      force_sel=torch.zeros_like(aux.force_sel))
    if work_tree is not None:
        return states, buf, aux, compact_subtree(work_tree, move, reuse_capacity)
    return states, buf, aux


def selfplay_step_tiered(states: GoState, buf: GameBuffer, aux: SelfplayAux,
                         eval_fn: EvalFn, params_sel: SearchParams,
                         params_fast: SearchParams, cfg: SelfplayConfig,
                         generator: Optional[torch.Generator] = None,
                         reuse_tree: Optional[Tree] = None,
                         reuse_capacity: int = 0, calib=None,
                         sel_mult_base=None,
                         draws: Optional[StepDraws] = None,
                         bias_table: Optional[BiasTable] = None):
    """One lockstep move with per-board playout-cap randomization
    (selfplay/loop.py:364-512 of the JAX package): in each of the
    `cfg.tier_groups` groups of boards, a uniformly random subset of
    round(B/G * trainable_move_prob) boards (force_sel boards first) runs
    the selected search, the rest the fast one, each tier at its own width.
    Each tier searches with its boards' rows of `bias_table` when its
    params have bias_lambda > 0.

    Returns (states, buf, aux, next_tree) with `reuse_tree`, else
    (states, buf, aux); with a bias table in use, the updated table is
    appended."""
    B = states.stones.shape[0]
    dev = states.stones.device
    G = tier_groups(B, cfg)
    Bg = B // G
    b_sel_g = tier_sizes(B, cfg)[0] // G
    if draws is None:
        draws = draw_step(B, cfg, generator, dev)
    # force_sel boards sort first within their group; group-local ranks.
    keys = torch.where(aux.force_sel, draws.perm_u - 2.0, draws.perm_u).reshape(G, Bg)
    perm_g = torch.argsort(keys, dim=1, stable=True)
    inv_g = torch.argsort(perm_g, dim=1, stable=True)
    base = torch.arange(G, device=dev)[:, None] * Bg
    flat = lambda idx_g: (idx_g + base).reshape(-1)  # group-local -> board
    tau = tau_schedule(states.move_count, cfg)

    if reuse_tree is not None:
        pre = root_pre_stats(reuse_tree, params_sel.c_visit, params_sel.c_scale)
    else:
        pre = _zero_pre_stats(B, dev)

    def run_tier(idx, params, noise, sample, raw):
        take = lambda x: x[idx]
        st = map_state(take, states)
        use_bias = bias_table is not None and params.bias_lambda > 0
        bt = map_state(take, bias_table) if use_bias else None
        if reuse_tree is not None:
            out = search_root(st, eval_fn, params, tau=take(tau),
                              init_tree=map_state(take, reuse_tree),
                              reuse_capacity=reuse_capacity,
                              gumbel_noise=noise, sample_gumbel=sample,
                              bias_table=bt)
            res, work, bt = out if use_bias else (*out, None)
        else:
            out = search_root(st, eval_fn, params, tau=take(tau),
                              gumbel_noise=noise, sample_gumbel=sample,
                              bias_table=bt)
            res, bt = out if use_bias else (out, None)
            work = None
        move, sampling_raw, over = _choose_move(st, res, take(aux.raw_until), raw)
        if work is not None:
            ntree = compact_subtree(work, move, reuse_capacity)
            nn_q, nn_unc = work.init_util[:, 0], work.init_err[:, 0]
        else:
            ntree = None
            nn_q, nn_unc = take(pre.nn_q), take(pre.nn_uncertainty)
        return (res, move, sampling_raw, over, nn_q, nn_unc), ntree, bt

    out_sel, tree_sel, bias_sel = run_tier(flat(perm_g[:, :b_sel_g]), params_sel,
                                           draws.sel_noise, draws.sel_sample,
                                           draws.sel_raw)
    out_fast, tree_fast, bias_fast = run_tier(flat(perm_g[:, b_sel_g:]), params_fast,
                                              draws.fast_noise, draws.fast_sample,
                                              draws.fast_raw)

    def unperm(a, b_):
        """Tier rows back to board order, group by group."""
        merged = torch.cat([a.reshape(G, b_sel_g, *a.shape[1:]),
                            b_.reshape(G, Bg - b_sel_g, *b_.shape[1:])], dim=1)
        return merged.reshape(B, *a.shape[1:])[flat(inv_g)]

    res = map_state(unperm, out_sel[0], out_fast[0])
    move, sampling_raw, over, nn_q_root, nn_unc_root = (
        unperm(a, b_) for a, b_ in zip(out_sel[1:], out_fast[1:]))
    next_tree = (map_state(unperm, tree_sel, tree_fast)
                 if reuse_tree is not None else None)
    next_bias = (map_state(unperm, bias_sel, bias_fast)
                 if bias_sel is not None else None)

    is_sel = (inv_g < b_sel_g).reshape(-1)
    keep_prob, sel_modifier, sel_mult, down_bad_count = _selection_state(
        res, pre, aux, sampling_raw, cfg, calib, sel_mult_base)
    trainable = torch.where(
        aux.force_sel, ~sampling_raw,
        is_sel & ~sampling_raw & (draws.train_u < keep_prob * sel_mult))
    states, buf = _record_and_advance(states, buf, res, move, sampling_raw,
                                      over, pre, nn_q_root, nn_unc_root,
                                      trainable, keep_prob, sel_modifier, cfg)
    aux = SelfplayAux(raw_until=aux.raw_until, down_bad_count=down_bad_count,
                      force_sel=torch.zeros_like(aux.force_sel))
    out = (states, buf, aux) + ((next_tree,) if next_tree is not None else ()) \
        + ((next_bias,) if next_bias is not None else ())
    return out


def finished_mask(states: GoState, cfg: SelfplayConfig) -> torch.Tensor:
    return is_game_over(states) | (states.move_count >= cfg.max_game_len)


def final_scores(states: GoState):
    """Batched terminal scoring -> (black f32[B], white f32[B], ownership
    int8[B, 361]), Benson pass-alive analysis included (game/scoring.py)."""
    return score_board(states)


def reset_finished(states: GoState, buf: GameBuffer, aux: SelfplayAux,
                   done: torch.Tensor, komi,
                   generator: Optional[torch.Generator] = None,
                   max_raw_policy_moves: int = 30,
                   reuse_tree: Optional[Tree] = None,
                   uniform: Optional[torch.Tensor] = None,
                   init_states: Optional[GoState] = None,
                   use_init: Optional[torch.Tensor] = None,
                   no_raw: Optional[torch.Tensor] = None,
                   force_sel: Optional[torch.Tensor] = None,
                   bias_table: Optional[BiasTable] = None):
    """Replace finished boards (`done` [B]) with fresh games, or with
    restart positions, and clear their records (buffer rows in place)
    (loop.py:524-575 of the JAX package; GetInitState,
    self_play_thread.cc:203-254).

    `komi` is a scalar or [B]. `init_states` / `use_init` [B] supply
    per-board restart positions (GoExploit reuse, book, handicap). The new
    raw-policy opening length is floor(U * (max_raw + 1)) with U from
    `generator` or `uniform` [B], max_raw decaying with the start move
    number at a half-life of 40 moves (self_play_thread.cc:362-366);
    `no_raw` [B] boards get none, and `force_sel` [B] forces a full search
    and a trainable first move (FirstMoveBehavior kPlay / kForceFullSearch,
    reuse_buffer.h:19-26). The bias cache is per-game knowledge: finished
    boards' rows of `bias_table` are cleared (the reference's per-move
    PruneUnused fades them once their game's nodes are reaped). Returns
    (states, buf, aux), then the reset tree when `reuse_tree` is given and
    the reset table when `bias_table` is."""
    B = states.stones.shape[0]
    dev = states.stones.device
    repl = new_state(B, komi, device=dev, history=states.history.shape[1])
    if init_states is not None:
        repl = select_state(done & use_init, init_states, repl)
    states = select_state(done, repl, states)
    for arr in buf:
        arr[done] = 0
    max_raw = torch.round(float(max_raw_policy_moves)
                          * 0.5 ** (states.move_count.float() / 40.0)).to(torch.int32)
    if uniform is None:
        uniform = torch.rand(B, generator=generator, device=dev)
    new_raw = torch.floor(uniform * (max_raw + 1).float()).to(torch.int32)
    if no_raw is not None:
        new_raw = torch.where(no_raw, torch.zeros_like(new_raw), new_raw)
    new_force = aux.force_sel
    if force_sel is not None:
        new_force = torch.where(done, force_sel, aux.force_sel)
    aux = SelfplayAux(
        raw_until=torch.where(done, states.move_count + new_raw, aux.raw_until),
        down_bad_count=torch.where(done, torch.zeros_like(aux.down_bad_count),
                                   aux.down_bad_count),
        force_sel=new_force,
    )
    out = (states, buf, aux)
    if reuse_tree is not None:
        empty = make_tree(B, reuse_tree.n.shape[1], dev)
        out += (select_state(done, empty, reuse_tree),)
    if bias_table is not None:
        empty_b = make_bias_table(B, bias_table.key0.shape[1], dev)
        out += (select_state(done, empty_b, bias_table),)
    return out
