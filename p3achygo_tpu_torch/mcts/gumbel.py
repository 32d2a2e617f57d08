"""Batched Gumbel AlphaZero root search with sequential halving (port of
p3achygo_tpu/mcts/gumbel.py; reference cc/mcts/gumbel.cc).

Same semantics as the JAX search, which the tests hold this port to:
Gumbel + logit + q-transform ranking and sequential-halving rounds with
v_r = round(n / (rounds * k_r)) visits per candidate (gumbel.cc:388-473);
non-root descent by the completed-Q improved-policy disparity rule
(gumbel.cc:214-237); leaf evaluation with the direct or the integral score
utility (leaf_evaluator.cc:12-131); cheap 1-step Tromp-Taylor or exact
Benson terminal scoring; root improved policy, tau sampling and root
stitching (gumbel.cc:154-193, 510-557); grouped visits (`visit_group`);
tree reuse through `init_tree`; confidence-based early stopping and
over-search (gumbel.cc:326-352, 397-409); MCGS graph search
(node_table.h:78-120, tree.McgsTable); the local-pattern value-bias cache
(mcts/bias.py). The documented deviations of the JAX search carry over:
in-tree legality is the cheap mask, root VMixed is init_util, MCGS inserts
are deferred to the end of a sweep and its backup stays incremental, bias
statistics accumulate once per search.

What changes is the machinery. The JAX search read tree rows through
one-hot contractions and accumulated backups with one-hot einsums, because
a TPU serialises gathers and scatters; here rows are read with indexing
and backups accumulate with `index_add_` (several lanes of a grouped visit
can reach the same node, so every accumulation adds, never assigns).
Where lanes may write one slot with different values, `tree.scatter_last`
keeps the last lane's, as XLA:CPU's scatter does. Inside a search the
working tree is private and updated in place.

Control flow that JAX keeps on the device (`lax.while_loop`, `lax.cond`)
is a Python loop or branch here, each test one host sync: one per descent
level, one per early-stopping sweep, one per sweep with exact terminal
scoring. `COUNTERS` counts them, with the MCGS hits and early stops,
and, while `tracing` is on, times them. The search's
stages are `tracing` spans (`search.root`, `search.sweep`,
`search.descent`, ...).

Randomness: the Gumbel root noise (gumbel.py:850-851) and the tau-sampling
Gumbel draw (gumbel.py:1579-1584) come from the `generator` argument, or
are passed in ready-drawn (`gumbel_noise`, `sample_gumbel`) so tests can
inject the JAX draws. JAX's `categorical` is Gumbel-max, so the sample is
argmax(logits + sample_gumbel).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from p3achygo_tpu_torch import tracing
from p3achygo_tpu_torch.constants import (
    BLACK,
    BOARD_LEN,
    NUM_LOCS,
    NUM_MOVES,
    NUM_SCORE_LOGITS,
    NUM_V_BUCKETS,
    PASS_MOVE,
    SCORE_INFLECTION_POINT,
)
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import (
    GoState,
    NEIGHBORS,
    _pad,
    is_game_over,
    legal_mask_batch,
    map_state,
    step,
)
from p3achygo_tpu_torch.game.symmetry import (
    SYM_SCATTER,
    apply_symmetry_action,
    apply_symmetry_grid_batch,
)
from p3achygo_tpu_torch.game.scoring import score as score_board
from p3achygo_tpu_torch.mcts.bias import bias_accumulate, bias_probe, local_pattern_keys
from p3achygo_tpu_torch.mcts.tree import (
    MAX_Q,
    MIN_Q,
    V_BUCKET_RANGE,
    Tree,
    child_visits,
    make_mcgs_table,
    make_tree,
    mcgs_insert,
    mcgs_meta,
    mcgs_probe,
    q_of_children,
    saturating_edge_add,
    scatter_last,
    welford_m3_delta,
)
from p3achygo_tpu_torch.ops.liberties import point_liberties_batch
from p3achygo_tpu_torch.nn.serve import ServeNet, serve_supported
from p3achygo_tpu_torch.nn.serve_q import ServeQNet, q_supported
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn, trunk_supported

_BIG_NEG = -1e9
_NEW_MARK = -2  # path placeholder for this sweep's newly allocated node


class EvalOutput(NamedTuple):
    """Per-board NN outputs search needs (to-move perspective)."""

    log_priors: torch.Tensor  # f32[B, 362] log-softmax policy
    outcome_value: torch.Tensor  # f32[B] E[win] - E[loss]
    score_est: torch.Tensor  # f32[B]
    score_var: torch.Tensor  # f32[B]
    err_est: Optional[torch.Tensor] = None  # f32[B] sqrt(q6_err); None -> 0


EvalFn = Callable[[GoState], EvalOutput]


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration (GumbelSearchParams, gumbel.h:18-66);
    the JAX package's fields and defaults."""

    n: int = 32
    k: int = 4
    max_depth: int = 24
    noise_scale: float = 1.0
    tau: float = 0.0
    c_visit: float = 50.0
    c_scale: float = 1.0
    score_weight: float = 0.5
    score_utility_mode: str = "direct"
    disable_pass: bool = False
    terminal_mode: str = "cheap"
    early_stopping: bool = False
    over_search: bool = False
    search_confidence: float = 0.95
    use_mcgs: bool = False
    bias_lambda: float = 0.0
    bias_alpha: float = 0.8
    visit_group: int = 1


class SearchCounters:
    """What searches did since the last `reset()`: search calls, host syncs
    by cause (`syncs`), while `tracing` is on the host ns blocked in them
    by cause (`sync_wait_ns`), leaves scored exactly, and device-side sums
    (MCGS hits, boards that stopped a round early) read with one sync by
    `snapshot()`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.searches = 0
        self.syncs = collections.Counter()
        self.sync_wait_ns = collections.Counter()
        self.exact_scored = 0
        self._sums = {}

    def add(self, name: str, t: torch.Tensor) -> None:
        cur = self._sums.get(name)
        v = t.sum()
        self._sums[name] = v if cur is None else cur + v.to(cur.device)

    def snapshot(self) -> dict:
        out = {"searches": self.searches, "syncs": dict(self.syncs),
               "exact_scored": self.exact_scored}
        out.update({k: int(v) for k, v in self._sums.items()})
        return out


COUNTERS = SearchCounters()


def _sync(cond: torch.Tensor, cause: str) -> bool:
    """bool(cond), counted as one host sync of `cause`."""
    return _synced(cause, bool, cond)


def _synced(cause: str, fn, arg):
    """fn(arg), a call that waits for the device, counted as one host sync
    of `cause` and, while tracing is on, timed."""
    COUNTERS.syncs[cause] += 1
    if not tracing.is_on():
        return fn(arg)
    t0 = time.perf_counter_ns()
    out = fn(arg)
    COUNTERS.sync_wait_ns[cause] += time.perf_counter_ns() - t0
    return out


def _eval(eval_fn: EvalFn, states: GoState, kind: str) -> EvalOutput:
    """eval_fn(states) as a search calls it, spanned as `search.eval` with
    the rows it is given."""
    with tracing.span("search.eval", kind=kind, rows=states.stones.shape[0]):
        return eval_fn(states)


class GumbelResult(NamedTuple):
    mcts_move: torch.Tensor  # int64[B]
    raw_nn_move: torch.Tensor  # int64[B]
    pi_improved: torch.Tensor  # f32[B, 362]
    root_value: torch.Tensor  # f32[B]
    root_outcome: torch.Tensor  # f32[B]
    root_score_est: torch.Tensor  # f32[B]
    q_selected: torch.Tensor  # f32[B]
    qz_selected: torch.Tensor  # f32[B]
    kld: torch.Tensor  # f32[B]
    visits: torch.Tensor  # int32[B]
    root_child_visits: torch.Tensor  # int32[B, 362]
    root_priors: torch.Tensor  # f32[B, 362]
    root_value_dist: torch.Tensor  # int32[B, 51]
    root_child_q: torch.Tensor  # f32[B, 362]


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1) (the form
    of jax.random.gumbel)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def make_eval_fn(model, symmetrize: bool = True, include_ladders: bool = False,
                 p_opt_weight: float = 0.0, use_fused_trunk: bool = False,
                 serve_fold: bool = False, serve_q_scales=None) -> EvalFn:
    """NN eval adapter: featurize, run the network, reduce its outputs.

    With `symmetrize`, each position is evaluated under the D4 symmetry
    `hash[:, 0] % 8` and the policy is mapped back (nn_interface.cc:123-127;
    the hash-derived choice is the JAX package's). `include_ladders` fills
    the laddered-stones planes, read on the symmetrized state: its chain
    labels are permuted, not renumbered, as in JAX, so the ladder reader
    (which takes a chain whose label is its own point as a candidate) can
    see fewer candidates under some symmetries. `p_opt_weight` blends
    the optimistic policy head into the priors in probability space,
    (1-w)*softmax(pi) + w*softmax(pi_opt) (JAX gumbel.py:289-295).
    `serve_fold` runs the folded, head-pruned `nn/serve.py` forward, built
    once here, where `serve_supported` (not for the transformer trunk,
    which falls back to the plain forward). `use_fused_trunk` runs the
    trunk in the hand-written kernels (`nn/trunk_kernel.py`, folded once
    here) for btl networks and is ignored for others. `serve_q_scales` (a
    site -> scale dict from `nn/serve_q.py calibrate`) runs the
    int8-activation `ServeQNet`, built once here, where `q_supported`. As
    in the JAX package (gumbel.py:216-247), serve_q takes precedence over
    `serve_fold`, which takes precedence over the fused trunk."""
    trunk_fn = None
    want_optimistic = p_opt_weight > 0.0
    if serve_q_scales is not None and q_supported(model.config):
        qnet = ServeQNet(model, want_optimistic)
        net = lambda planes, scalars: qnet(planes, scalars, serve_q_scales)
        route = "serveq"
    elif serve_fold and serve_supported(model.config):
        net = ServeNet(model, want_optimistic)
        route = "fold"
    else:
        route = "plain"
        if use_fused_trunk and trunk_supported(model.config):
            trunk_fn = build_trunk_fn(model.config, model)
            route = "fused"
        net = functools.partial(model, trunk_fn=trunk_fn)
    score_values = None

    @torch.no_grad()
    def eval_fn(states: GoState) -> EvalOutput:
        nonlocal score_values
        dev = states.stones.device
        if symmetrize:
            # Symmetrize the state, not the planes; chain labels stay unique
            # under a permutation of positions.
            sym = states.hash[:, 0] % 8
            ko = states.ko_point
            ko_on = (ko >= 0) & (ko < NUM_LOCS)
            ko_mapped = SYM_SCATTER.on(dev)[sym, ko.long().clamp(0, NUM_LOCS - 1)]
            states = states._replace(
                stones=apply_symmetry_grid_batch(states.stones, sym),
                chain_id=apply_symmetry_grid_batch(states.chain_id, sym),
                last_moves=apply_symmetry_action(states.last_moves, sym),
                ko_point=torch.where(ko_on, ko_mapped.to(ko.dtype), ko),
            )
        with tracing.span("eval.features", rows=states.stones.shape[0]):
            planes, scalars = batched_features(states, include_ladders,
                                               planes_dtype=model.dtype)
        with tracing.span("eval.forward", route=route):
            out = net(planes, scalars)
        pi_logits = out.pi_logits
        if p_opt_weight > 0.0:
            w = float(p_opt_weight)
            blend = ((1.0 - w) * torch.softmax(pi_logits, dim=-1)
                     + w * torch.softmax(out.pi_logits_optimistic, dim=-1))
            pi_logits = torch.log(blend.clamp(min=1e-30))
        if symmetrize:
            board = pi_logits[:, :NUM_LOCS].gather(1, SYM_SCATTER.on(dev)[sym])
            pi_logits = torch.cat([board, pi_logits[:, NUM_LOCS:]], dim=1)
        if score_values is None or score_values.device != dev:
            score_values = (torch.arange(NUM_SCORE_LOGITS, dtype=torch.float32,
                                         device=dev)
                            - SCORE_INFLECTION_POINT + 0.5)
        value = out.outcome_probs[:, 1] - out.outcome_probs[:, 0]
        score_est = (out.score_probs * score_values).sum(dim=-1)
        score_sq = (out.score_probs * score_values ** 2).sum(dim=-1)
        return EvalOutput(
            log_priors=torch.log_softmax(pi_logits, dim=-1),
            outcome_value=value,
            score_est=score_est,
            score_var=(score_sq - score_est ** 2).clamp(min=0.0),
            err_est=torch.sqrt(out.q6_err.clamp(min=0.0)),
        )

    return eval_fn


def uniform_eval_fn(states: GoState) -> EvalOutput:
    """Dummy NN: uniform policy, zero value (tests / benchmarks)."""
    B = states.stones.shape[0]
    dev = states.stones.device
    logp = -torch.log(torch.tensor(float(NUM_MOVES), dtype=torch.float32))
    z = torch.zeros(B, dtype=torch.float32, device=dev)
    return EvalOutput(
        log_priors=torch.full((B, NUM_MOVES), logp.item(), dtype=torch.float32,
                              device=dev),
        outcome_value=z, score_est=z.clone(), score_var=z.clone())


def _score_utility(score_weight: float, score_est: torch.Tensor,
                   root_score_signed: torch.Tensor) -> torch.Tensor:
    """Direct-mode score utility (leaf_evaluator.cc:79-82 ScoreTransform)."""
    return score_weight * (2.0 / math.pi) * torch.atan(
        (score_est - root_score_signed) / BOARD_LEN)


def _score_utility_integral(score_weight: float, score_est: torch.Tensor,
                            score_stddev: torch.Tensor,
                            root_score_signed: torch.Tensor) -> torch.Tensor:
    """Gaussian-integral score utility (kIntegral, leaf_evaluator.cc:12-77):
    E_z[(2/pi) atan((mean + z*sigma)/19)] under a standard normal truncated
    to z in [-5, 5] at step 0.1, mean = score_est - 0.75 * root_score
    (ScoreTransformIntegral:49-54), computed directly per lane as in the
    JAX package (no table interpolation)."""
    z = torch.arange(-50, 51, dtype=torch.float32, device=score_est.device) * 0.1
    pdf = torch.exp(-0.5 * z * z)
    mean = score_est - 0.75 * root_score_signed
    vals = torch.atan((mean[..., None] + z * score_stddev[..., None]) / BOARD_LEN)
    integral = (2.0 / math.pi) * (vals * pdf).sum(dim=-1) / pdf.sum()
    return score_weight * integral


def _leaf_score_utility(params, score_est: torch.Tensor, score_var: torch.Tensor,
                        root_score_signed: torch.Tensor) -> torch.Tensor:
    """Score utility by `params.score_utility_mode` (ScoreUtility,
    leaf_evaluator.cc:124-131)."""
    if params.score_utility_mode == "integral":
        return _score_utility_integral(params.score_weight, score_est,
                                       torch.sqrt(score_var.clamp(min=0.0)),
                                       root_score_signed)
    return _score_utility(params.score_weight, score_est, root_score_signed)


_T_TABLE_MAX_DF = 512


@functools.lru_cache(maxsize=64)
def _t_quantile_np(alpha: float, max_df: int) -> np.ndarray:
    p = 1.0 - alpha / 2.0
    try:
        from scipy.stats import t as _t
        tab = _t.ppf(p, np.arange(1, max_df + 1))
    except ImportError:  # Cornish-Fisher expansion around the normal quantile
        from statistics import NormalDist
        z = NormalDist().inv_cdf(p)
        df = np.arange(1, max_df + 1, dtype=np.float64)
        tab = z + (z**3 + z) / (4.0 * df) \
            + (5 * z**5 + 16 * z**3 + 3 * z) / (96.0 * df**2)
    return np.asarray(tab, np.float32)


def _t_quantile_table(alpha: float, max_df: int = _T_TABLE_MAX_DF,
                      device="cpu") -> torch.Tensor:
    """Two-sided Student-t quantiles for df = 1..max_df (ZScore,
    tree.cc:36-39: quantile(complement(t_dist(n-1), alpha/2))), f32."""
    return torch.from_numpy(_t_quantile_np(float(alpha), max_df)).to(device)


def _can_stop_early(tree: Tree, cand_actions: torch.Tensor, cand_valid: torch.Tensor,
                    k_r: int, base_score: torch.Tensor, ztab: torch.Tensor,
                    params: "SearchParams") -> torch.Tensor:
    """Per-board confidence check (can_stop_early, gumbel.cc:326-352) ->
    bool[B]: every live candidate's root edge has >= 10 visits and the
    bottom half's max Q-UCB (by current Gumbel + q-transform score) is <=
    the top half's max Q-LCB; Student-t intervals on edge Q with the child
    node's variance (ConfidenceInterval, tree.cc:41-51)."""
    B, N = tree.n.shape
    ca = cand_actions[:, :k_r]
    valid = cand_valid[:, :k_r]
    root_en = tree.edge_n[:, 0, :].float()
    n_a = root_en.gather(1, ca)
    w_a = tree.edge_w[:, 0, :].gather(1, ca)
    q_a = torch.where(n_a > 0, -(w_a / n_a.clamp(min=1.0)), MIN_Q)
    child = tree.children[:, 0, :].gather(1, ca).long()
    b = torch.arange(B, device=ca.device)[:, None]
    vvar_sum = tree.v_var_sum[b, child.clamp(0, N - 1)]
    # VVar: v_var_sum / n, kMaxQ when n < 3 (tree.h:126-130).
    qvar = torch.where(n_a >= 3, vvar_sum / n_a.clamp(min=1.0), MAX_Q)
    df = (n_a.long() - 1).clamp(1, _T_TABLE_MAX_DF)
    z = ztab[df - 1]
    std = torch.sqrt(qvar.clamp(min=0.0) / n_a.clamp(min=1.0))
    lcb, ucb = q_a - z * std, q_a + z * std
    ok = (~valid | ((child >= 0) & (n_a >= 10.0))).all(dim=1)
    # Partition by the current score order: the top k/2 give LCBs, the
    # rest UCBs; ties rank the lower candidate index first.
    maxn = root_en.max(dim=-1).values
    score_a = base_score.gather(1, ca) \
        + (params.c_visit + maxn[:, None]) * params.c_scale * q_a
    score_a = torch.where(valid, score_a, _BIG_NEG)
    gt = score_a[:, None, :] > score_a[:, :, None]
    eq = score_a[:, None, :] == score_a[:, :, None]
    ar = torch.arange(k_r, device=ca.device)
    jlt = (ar[None, :] < ar[:, None])[None]
    rank = (gt | (eq & jlt)).sum(dim=2)
    top = valid & (rank < k_r // 2)
    bot = valid & (rank >= k_r // 2)
    top_lcb = torch.where(top, lcb, -2.0).max(dim=1).values
    bot_ucb = torch.where(bot, ucb, -2.0).max(dim=1).values
    return ok & (bot_ucb <= top_lcb)


def _cheap_scores(states: GoState):
    """1-step Tromp-Taylor: stones + empties adjacent to exactly one colour
    -> (black, white) f32[B] each (white includes komi)."""
    stones = states.stones
    nbr = _pad(stones, 99)[:, NEIGHBORS.on(stones.device)]  # [B, 361, 4]
    empty = stones == 0
    b_adj = (nbr == 1).any(dim=2)
    w_adj = (nbr == -1).any(dim=2)
    b = ((stones == 1) | (empty & b_adj & ~w_adj)).sum(dim=1)
    w = ((stones == -1) | (empty & w_adj & ~b_adj)).sum(dim=1)
    return b.float(), w.float() + states.komi


def _init_nodes(tree: Tree, node: torch.Tensor, ev: EvalOutput,
                color: torch.Tensor, util: torch.Tensor, active: torch.Tensor,
                b: torch.Tensor) -> None:
    """Write NN evals into node slots in place (InitFields,
    leaf_evaluator.cc:93-122). Inactive rows route to the spare slot and
    write back its old value."""
    spare = tree.n.shape[1] - 1
    node = torch.where(active, node.long(), torch.full_like(node.long(), spare))
    err = ev.err_est if ev.err_est is not None else torch.zeros_like(ev.outcome_value)

    def put(arr, new):
        old = arr[b, node]
        m = active.reshape(active.shape + (1,) * (old.dim() - 1))
        arr[b, node] = torch.where(m, new.to(arr.dtype), old)

    put(tree.log_priors, ev.log_priors)
    put(tree.init_err, err)
    put(tree.init_outcome, ev.outcome_value)
    put(tree.init_score, ev.score_est)
    put(tree.init_util, util)
    put(tree.color, color)
    tree.evaluated[b, node] = tree.evaluated[b, node] | active


def _completed_q_policy(logp: torch.Tensor, edge_n: torch.Tensor,
                        edge_w: torch.Tensor, node_n: torch.Tensor,
                        init_util: torch.Tensor, c_visit: float,
                        c_scale: float) -> torch.Tensor:
    """Completed-Q improved policy (ComputeImprovedPolicy, gumbel.cc:196-212)
    over the last axis: logp / edge_n / edge_w [..., 362], node_n /
    init_util [...] -> pi f32[..., 362]."""
    visited = edge_n > 0
    q = torch.where(visited, -(edge_w / edge_n.float().clamp(min=1.0)), MIN_Q)
    sum_children = (node_n - 1).clamp(min=0).float()
    maxn = edge_n.max(dim=-1).values
    probs = torch.exp(logp)
    visited_prob = torch.where(visited, probs, 0.0).sum(dim=-1)
    weighted_q = torch.where(visited, probs * q, 0.0).sum(dim=-1)
    v_mix = torch.where(
        sum_children > 0,
        (weighted_q * sum_children / visited_prob.clamp(min=1e-10) + init_util)
        / (1.0 + sum_children),
        init_util)
    q_scale = torch.where(maxn > 0, 2.0 * torch.log(maxn.clamp(min=1).float()),
                          0.0)
    completed = torch.where(visited, (q + 1.5) / 3.0,
                            ((v_mix + 1.5) / 3.0)[..., None])
    logits = logp + ((c_visit + q_scale[..., None]) * c_scale) * completed
    return torch.softmax(logits, dim=-1)


class _Transitions(NamedTuple):
    """Per-(node, arrival rank) descent table of one sweep, [B, N, g]."""

    action: torch.Tensor  # int64 action the disparity rule picks
    child: torch.Tensor  # int64 child node along it, or -1
    terminal: torch.Tensor  # bool child is a known terminal node
    next_rank: torch.Tensor  # int64 arrival rank at the child


def _sweep_transitions(tree: Tree, c_visit: float, c_scale: float,
                       g: int) -> _Transitions:
    """The disparity-rule action of every node for each within-sweep
    arrival rank t < g, with the child, terminal flag and next rank along
    it. The tree is frozen during a sweep's descent, so the table is exact
    (the JAX `_sweep_action_table` with transitions, gather-based)."""
    pi = _completed_q_policy(tree.log_priors.float(), tree.edge_n, tree.edge_w,
                             tree.n, tree.init_util, c_visit, c_scale)
    en = tree.edge_n.float()
    sum_children = (tree.n - 1).clamp(min=0).float()
    N = tree.n.shape[1]
    extra = torch.zeros_like(pi)
    acts, childs, terms = [], [], []
    for t in range(g):
        disparity = pi - (en + extra) / (1.0 + sum_children + float(t))[:, :, None]
        a_t = torch.where(tree.s_legal, disparity, _BIG_NEG).argmax(dim=-1)
        if t < g - 1:
            extra.scatter_add_(2, a_t[:, :, None], torch.ones_like(extra[:, :, :1]))
        ch = tree.children.gather(2, a_t[:, :, None])[:, :, 0].long()
        tm = tree.is_terminal.gather(1, ch.clamp(0, N - 1)) & (ch >= 0)
        acts.append(a_t)
        childs.append(ch)
        terms.append(tm)
    act = torch.stack(acts, dim=-1)
    # Lanes taking the same action from the same node land on the same
    # child; their ranks there enumerate in t order.
    nr = torch.zeros_like(act)
    for t in range(1, g):
        nr[:, :, t] = (act[:, :, :t] == act[:, :, t:t + 1]).sum(dim=-1)
    return _Transitions(act, torch.stack(childs, dim=-1),
                        torch.stack(terms, dim=-1), nr)


def _backup(tree: Tree, bw: torch.Tensor, path_nodes: torch.Tensor,
            leaf_node: torch.Tensor, valid: torch.Tensor,
            path_actions: Optional[torch.Tensor] = None) -> None:
    """Back up one batch of simulations in place (Backward,
    gumbel.cc:738-761): lane w of board bw[w] walked `path_nodes` [W, D]
    (-1 past its end) to `leaf_node`, whose value every path node takes,
    sign-flipped into its own perspective. Leaf nodes keep v == init
    (SingleBackup is_leaf, gumbel.cc:763-771). Lanes may share nodes, so
    every statistic accumulates with `index_add_`. Edge statistics follow
    each node's (parent, parent_action) edge, or, with `path_actions`, the
    edge each path entry was reached through (its parent the previous path
    entry, the root for the first)."""
    B, N = tree.n.shape
    dev = tree.n.device
    leaf_q = tree.init_util[bw, leaf_node]
    leaf_qz = tree.init_outcome[bw, leaf_node]
    leaf_score = tree.init_score[bw, leaf_node]
    leaf_c = tree.color[bw, leaf_node]
    bD = bw[:, None]
    on_path = (path_nodes >= 0) & valid[:, None]
    node_s = path_nodes.clamp(0, N - 1)
    sign = torch.where(tree.color[bD, node_s] == leaf_c[:, None], 1.0, -1.0)
    is_leaf_slot = path_nodes == leaf_node[:, None]
    q = sign * leaf_q[:, None]
    qz = sign * leaf_qz[:, None]
    sc = sign * leaf_score[:, None]
    add_w = torch.where(is_leaf_slot, tree.init_util[bD, node_s], q)
    add_wz = torch.where(is_leaf_slot, tree.init_outcome[bD, node_s], qz)
    add_sc = torch.where(is_leaf_slot, tree.init_score[bD, node_s], sc)
    n_old = tree.n[bD, node_s].float()
    n_new = n_old + on_path.float()
    w_old = tree.w[bD, node_s]
    v_old = torch.where(n_old > 0, w_old / n_old.clamp(min=1), tree.init_util[bD, node_s])
    v_new = (w_old + torch.where(on_path, add_w, 0.0)) / n_new.clamp(min=1)
    dvar = (q - v_old) * (q - v_new)
    wz_old = tree.w_outcome[bD, node_s]
    vz_old = torch.where(n_old > 0, wz_old / n_old.clamp(min=1),
                         tree.init_outcome[bD, node_s])
    vz_new = (wz_old + torch.where(on_path, add_wz, 0.0)) / n_new.clamp(min=1)
    dvar_z = (qz - vz_old) * (qz - vz_new)
    dm3 = welford_m3_delta(q, v_old, n_new, tree.v_var_sum[bD, node_s], dvar)
    bucket = ((qz + 1.0) / V_BUCKET_RANGE).to(torch.int32).clamp(0, NUM_V_BUCKETS - 1)
    onp = on_path.float()
    nlf = (on_path & ~is_leaf_slot).float()

    flat = (bD * N + node_s).reshape(-1)
    stats = torch.stack([onp, add_w * onp, add_wz * onp, add_sc * onp,
                         dvar * nlf, dvar_z * nlf, dm3 * nlf], dim=-1)
    deltas = torch.zeros((B * N, 7), dtype=torch.float32, device=dev)
    deltas.index_add_(0, flat, stats.reshape(-1, 7))
    deltas = deltas.reshape(B, N, 7)
    cat = torch.zeros(B * N * NUM_V_BUCKETS, dtype=torch.int32, device=dev)
    cat.index_add_(0, flat * NUM_V_BUCKETS + bucket.reshape(-1).long(),
                   nlf.reshape(-1).to(torch.int32))
    d_n, d_w, d_wz = deltas[..., 0], deltas[..., 1], deltas[..., 2]

    if path_actions is None:
        par_valid = tree.parent >= 0
        bN = torch.arange(B, device=dev)[:, None] * N
        e_flat = ((bN + tree.parent.long().clamp(min=0)) * NUM_MOVES
                  + tree.parent_action.long()).reshape(-1)
        e_vals = [torch.where(par_valid, dv, 0.0) for dv in (d_n, d_w, d_wz)]
    else:
        parents = torch.cat([torch.zeros_like(node_s[:, :1]), node_s[:, :-1]], dim=1)
        e_flat = ((bD * N + parents) * NUM_MOVES + path_actions).reshape(-1)
        e_vals = [onp, add_w * onp, add_wz * onp]

    def edge_delta(dv):
        out = torch.zeros(B * N * NUM_MOVES, dtype=torch.float32, device=dev)
        out.index_add_(0, e_flat, dv.reshape(-1))
        return out.reshape(B, N, NUM_MOVES)

    tree.n.add_(d_n.to(torch.int32))
    tree.w.add_(d_w)
    tree.w_outcome.add_(d_wz)
    tree.score_sum.add_(deltas[..., 3])
    tree.v_var_sum.add_(deltas[..., 4])
    tree.vz_var_sum.add_(deltas[..., 5])
    tree.v_m3_sum.add_(deltas[..., 6])
    tree.v_categorical.add_(cat.reshape(B, N, NUM_V_BUCKETS))
    tree.edge_n.copy_(saturating_edge_add(tree.edge_n, edge_delta(e_vals[0])))
    tree.edge_w.add_(edge_delta(e_vals[1]))
    tree.edge_wz.add_(edge_delta(e_vals[2]))


def _schedule(params: SearchParams):
    """Sequential-halving rounds [(k_r, v_r)] (gumbel.cc:388-401: v_r =
    round(n / (num_rounds * k_r)) visits per candidate) and the node
    allocation bound of one search: over-search raises a round's budget to
    2.5x (gumbel.cc:397-409) and an early-stopping round's grouped last
    sweep can overshoot by g-1 visits per candidate."""
    k = params.k
    num_rounds = max(int(math.log2(k)) if k > 1 else 1, 1)
    es_enabled = params.early_stopping or params.over_search
    round_specs, k_r, max_alloc = [], k, 0
    while k_r > 1:
        v_r = max(int(round(params.n / (num_rounds * k_r))), 1)
        round_specs.append((k_r, v_r))
        budget_r = v_r * 5 // 2 if params.over_search else v_r
        g_r = max(1, min(params.visit_group, v_r))
        max_alloc += (budget_r + (g_r - 1 if es_enabled else 0)) * k_r
        k_r //= 2
    return round_specs, max_alloc


def visit_budget(params: SearchParams) -> int:
    """The most visits one board's search can spend (`visits`): sum over
    rounds of k_r times the round's budget, which early stopping and
    over-search reach in whole sweeps of g visits."""
    total = 0
    for k_r, v_r in _schedule(params)[0]:
        g = max(1, min(params.visit_group, v_r))
        if params.early_stopping or params.over_search:
            budget = v_r * 5 // 2 if params.over_search else v_r
            total += -(-budget // g) * g * k_r
        else:
            total += v_r * k_r
    return total


def search_root(states: GoState, eval_fn: EvalFn, params: SearchParams,
                generator: Optional[torch.Generator] = None,
                tau: Optional[torch.Tensor] = None,
                init_tree: Optional[Tree] = None,
                reuse_capacity: int = 0,
                gumbel_noise: Optional[torch.Tensor] = None,
                sample_gumbel: Optional[torch.Tensor] = None,
                bias_table=None):
    """Sequential-halving Gumbel search on a batch of boards, spanned as
    `search.root`.

    `tau` [B] overrides params.tau per board (tau <= 0 plays the top
    candidate). With `init_tree` (a compacted subtree, see
    tree.compact_subtree) and `reuse_capacity` > 0, reused roots keep their
    statistics and the call returns (result, working_tree); otherwise it
    returns the result. With `params.bias_lambda > 0` and a `bias_table`
    (mcts/bias.py), fresh leaf utilities are corrected by their pattern's
    observed error, the table accumulates this search's statistics, and the
    updated table is appended to the return: (result, bias_table) or
    (result, working_tree, bias_table). `gumbel_noise` / `sample_gumbel`
    ([B, 362], standard Gumbel) replace the draws from `generator`.
    """
    with tracing.span("search.root", n=params.n, k=params.k, rows=states.stones.shape[0]):
        return _search_root(states, eval_fn, params, generator, tau, init_tree,
                            reuse_capacity, gumbel_noise, sample_gumbel, bias_table)


def _search_root(states: GoState, eval_fn: EvalFn, params: SearchParams, generator,
                 tau, init_tree, reuse_capacity, gumbel_noise, sample_gumbel, bias_table):
    COUNTERS.searches += 1
    B = states.stones.shape[0]
    dev = states.stones.device
    b = torch.arange(B, device=dev)
    n, k = params.n, params.k
    num_rounds = max(int(math.log2(k)) if k > 1 else 1, 1)
    es_enabled = params.early_stopping or params.over_search
    use_bias = params.bias_lambda > 0 and bias_table is not None

    round_specs, max_alloc = _schedule(params)
    theoretical_winner_visits = sum(v for _, v in round_specs)

    max_nodes = max_alloc + 2 + (reuse_capacity if init_tree is not None else 0)
    tree = make_tree(B, max_nodes, dev)
    if init_tree is not None:
        R = init_tree.n.shape[1]
        for field in Tree._fields:
            if field != "next_free":
                getattr(tree, field)[:, :R] = getattr(init_tree, field)
        tree = tree._replace(next_free=init_tree.next_free.clone())
        reused = init_tree.evaluated[:, 0].clone()
    else:
        reused = torch.zeros(B, dtype=torch.bool, device=dev)

    # --- root eval (EvaluateRoot only for new roots, gumbel.cc:275-278) ---
    root_ev = _eval(eval_fn, states, "root")
    root_color = states.to_move
    zeros_b = torch.zeros(B, dtype=torch.long, device=dev)
    _init_nodes(tree, zeros_b, root_ev, root_color, root_ev.outcome_value,
                ~reused, b)
    bucket0 = ((root_ev.outcome_value + 1.0) / V_BUCKET_RANGE).to(torch.int32
                                                                 ).clamp(0, NUM_V_BUCKETS - 1)
    tree.n[:, 0] = torch.where(reused, tree.n[:, 0], torch.ones_like(tree.n[:, 0]))
    tree.w[:, 0] = torch.where(reused, tree.w[:, 0], root_ev.outcome_value)
    tree.w_outcome[:, 0] = torch.where(reused, tree.w_outcome[:, 0],
                                       root_ev.outcome_value)
    tree.score_sum[:, 0] = torch.where(reused, tree.score_sum[:, 0],
                                       root_ev.score_est)
    tree.v_categorical[b, 0, bucket0.long()] += (~reused).to(torch.int32)
    root_score_est = torch.where(reused, tree.init_score[:, 0], root_ev.score_est)

    # --- root candidates: logits + gumbel noise (gumbel.cc:287-306) ---
    legal_plain = legal_mask_batch(states)
    legal0 = legal_plain
    if params.disable_pass:
        has_board_move = legal0[:, :PASS_MOVE].any(dim=-1)
        legal0 = legal0.clone()
        legal0[:, PASS_MOVE] = legal0[:, PASS_MOVE] & ~has_board_move

    # Store the root board in node 0's state slots.
    tree.s_stones[:, 0] = states.stones
    tree.s_chain[:, 0] = states.chain_id.to(torch.int16)
    tree.s_last5[:, 0] = states.last_moves.to(torch.int16)
    tree.s_ko[:, 0] = states.ko_point.to(torch.int16)
    tree.s_cpass[:, 0] = states.consecutive_passes.to(torch.int8)
    tree.s_hash[:, 0] = states.hash
    tree.s_legal[:, 0] = legal_plain

    root_log_priors = tree.log_priors[:, 0, :].float()
    masked_logp = torch.where(legal0, root_log_priors, _BIG_NEG)
    if gumbel_noise is None:
        gumbel_noise = gumbel((B, NUM_MOVES), generator, dev)
    gnoise = torch.where(legal0, params.noise_scale * gumbel_noise, 0.0)
    base_score = masked_logp + gnoise
    raw_nn_move = root_log_priors.argmax(dim=-1)
    board_over = is_game_over(states)

    def finish(result):
        out = (result,) + ((tree,) if init_tree is not None else ()) \
            + ((bias_table,) if use_bias else ())
        return out if len(out) > 1 else result

    if n <= 1:
        # Play the gumbel-top legal move (gumbel.cc:312-316).
        pi = torch.softmax(masked_logp, dim=-1)
        top_legal = base_score.argmax(dim=-1)
        any_legal = legal0.any(dim=-1)
        mcts_move1 = torch.where(any_legal & ~board_over, top_legal,
                                 torch.full_like(top_legal, PASS_MOVE))
        return finish(GumbelResult(
            mcts_move=mcts_move1, raw_nn_move=raw_nn_move, pi_improved=pi,
            root_value=root_ev.outcome_value, root_outcome=root_ev.outcome_value,
            root_score_est=root_score_est,
            q_selected=torch.full((B,), MIN_Q, device=dev),
            qz_selected=torch.full((B,), -1.0, device=dev),
            kld=torch.zeros(B, device=dev),
            visits=torch.zeros(B, dtype=torch.int32, device=dev),
            root_child_visits=torch.zeros((B, NUM_MOVES), dtype=torch.int32,
                                          device=dev),
            root_priors=pi,
            root_value_dist=torch.zeros((B, NUM_V_BUCKETS), dtype=torch.int32,
                                        device=dev),
            root_child_q=torch.full((B, NUM_MOVES), MIN_Q, device=dev)))

    # Top-k by a stable descending sort: ties keep the lower index first.
    cand_actions = torch.sort(base_score, dim=1, descending=True,
                              stable=True).indices[:, :k]
    cand_valid = legal0.gather(1, cand_actions)

    spare = max_nodes - 1  # reserved dummy slot for inactive-lane writes
    D = params.max_depth
    N = max_nodes

    def one_sweep(tree: Tree, k_r: int, cand_actions, cand_valid, group: int,
                  stopped=None, mcgs=None) -> Tree:
        """One (k_r * group)-wide visit sweep: every live candidate gets
        `group` simulations at once (SearchParams.visit_group). `stopped`
        [B] marks boards whose round ended early: their lanes idle. With an
        MCGS table `mcgs`, new leaves link to a transposed node when the
        table has one (GetOrCreate, node_table.h:88-101)."""
        L = k_r * group
        W = B * L
        bw = torch.arange(W, device=dev) // L
        lane = torch.arange(W, device=dev)
        root_color_w = root_color[bw]
        root_score_w = root_score_est[bw]
        action0 = cand_actions[:, :k_r].repeat_interleave(group, dim=1).reshape(-1)
        valid0 = (cand_valid[:, :k_r].repeat_interleave(group, dim=1).reshape(-1)
                  & ~board_over[bw])
        if stopped is not None:
            valid0 = valid0 & ~stopped[bw]
        lane_lt = (torch.arange(L, device=dev)[None, :]
                   < torch.arange(L, device=dev)[:, None])[None]

        # --- descent (Search, gumbel.cc:674-727): table lookups only ---
        with tracing.span("search.descent") as descent:
            tr = _sweep_transitions(tree, params.c_visit, params.c_scale, group)
            path_nodes = torch.full((W, D), -1, dtype=torch.long, device=dev)
            path_actions = None
            levels = 0
            if mcgs is None:
                # Tree mode: level 0 follows the candidate edge; below it the
                # whole (node, arrival rank) transition comes from the table.
                child0 = tree.children[bw, 0, action0].long()
                term0 = tree.is_terminal[bw, child0.clamp(0, N - 1)] & (child0 >= 0)
                need0 = (child0 < 0) & valid0
                cur = torch.where(valid0, torch.where(need0, torch.full_like(child0, _NEW_MARK),
                                                      child0), torch.zeros_like(child0))
                path_nodes[:, 0] = torch.where(valid0, cur, torch.full_like(cur, -1))
                alloc_parent = torch.where(need0, 0, spare).long()
                alloc_action = torch.where(need0, action0, torch.zeros_like(action0))
                done = ~valid0 | need0 | term0
                rank = lane % group  # replicas of a candidate are lane-contiguous
                depth = valid0.long()

                while not _sync(done.all(), "descent"):
                    levels += 1
                    active = ~done
                    node_c = cur.clamp(0, N - 1)
                    r = rank.clamp(0, group - 1)
                    child = tr.child[bw, node_c, r]
                    a = tr.action[bw, node_c, r]
                    term = tr.terminal[bw, node_c, r]
                    new_rank = tr.next_rank[bw, node_c, r]
                    need_alloc = (child < 0) & active
                    child_idx = torch.where(need_alloc, torch.full_like(child, _NEW_MARK), child)
                    alloc_parent = torch.where(need_alloc, node_c, alloc_parent)
                    alloc_action = torch.where(need_alloc, a, alloc_action)
                    stop = (need_alloc | term) & active
                    d_idx = depth.clamp(max=D - 1)
                    path_nodes[lane, d_idx] = torch.where(active, child_idx,
                                                          path_nodes[lane, d_idx])
                    cur = torch.where(active, child_idx, cur)
                    rank = torch.where(active, new_rank, rank)
                    depth = depth + active.long()
                    done = done | stop | (depth >= D)
            else:
                # Graph mode: a transposed node can be shared across
                # candidates, so arrival ranks are counted per level among the
                # board's active lanes at the same node (ranks >= group take
                # action 0, as in the JAX search), and the traversed actions
                # are kept for the edge backup.
                path_actions = torch.zeros((W, D), dtype=torch.long, device=dev)
                cur = torch.zeros(W, dtype=torch.long, device=dev)
                depth = torch.zeros(W, dtype=torch.long, device=dev)
                done = ~valid0
                alloc_parent = torch.full((W,), spare, dtype=torch.long, device=dev)
                alloc_action = torch.zeros(W, dtype=torch.long, device=dev)
                while not _sync(done.all(), "descent"):
                    levels += 1
                    active = ~done
                    node_c = cur.clamp(0, N - 1)
                    if group == 1:
                        a_policy = tr.action[bw, node_c, 0]
                    else:
                        nodeb = cur.reshape(B, L)
                        actb = active.reshape(B, L)
                        eq = ((nodeb[:, :, None] == nodeb[:, None, :])
                              & actb[:, :, None] & actb[:, None, :])
                        rank = (eq & lane_lt).sum(dim=2).reshape(-1)
                        a_pick = tr.action[bw, node_c, rank.clamp(0, group - 1)]
                        a_policy = torch.where(rank < group, a_pick, torch.zeros_like(a_pick))
                    a = torch.where(depth == 0, action0, a_policy)
                    child = tree.children[bw, node_c, a].long()
                    need_alloc = (child < 0) & active
                    child_idx = torch.where(need_alloc, torch.full_like(child, _NEW_MARK), child)
                    alloc_parent = torch.where(need_alloc, node_c, alloc_parent)
                    alloc_action = torch.where(need_alloc, a, alloc_action)
                    known_terminal = (child >= 0) & tree.is_terminal[bw, child_idx.clamp(0, N - 1)]
                    stop = (need_alloc | known_terminal) & active
                    d_idx = depth.clamp(max=D - 1)
                    path_nodes[lane, d_idx] = torch.where(active, child_idx,
                                                          path_nodes[lane, d_idx])
                    path_actions[lane, d_idx] = torch.where(active, a, path_actions[lane, d_idx])
                    cur = torch.where(active, child_idx, cur)
                    depth = depth + active.long()
                    done = done | stop | (depth >= D)
            descent.set(levels=levels)

        # --- leaf board: the alloc parent's stored position + one step ---
        with tracing.span("search.leaf"):
            want = (cur == _NEW_MARK) & valid0
            par = torch.where(want, alloc_parent, torch.zeros_like(alloc_parent))
            zi32 = torch.zeros(W, dtype=torch.int32, device=dev)
            par_state = GoState(
                stones=tree.s_stones[bw, par],
                chain_id=tree.s_chain[bw, par].to(torch.int32),
                hash=tree.s_hash[bw, par],
                history=torch.zeros((W, 0, 2), dtype=torch.int64, device=dev),
                history_len=zi32,
                last_moves=tree.s_last5[bw, par].to(torch.int32),
                to_move=tree.color[bw, par],
                ko_point=tree.s_ko[bw, par].to(torch.int32),
                consecutive_passes=tree.s_cpass[bw, par].to(torch.int32),
                passes=zi32, move_count=zi32,
                komi=states.komi.repeat_interleave(L),
                num_b_prisoners=zi32, num_w_prisoners=zi32,
                pass_alive=states.pass_alive.repeat_interleave(L, dim=0),
                pa_move=zi32,
            )
            leaf_action = torch.where(want, alloc_action,
                                      torch.full_like(alloc_action, PASS_MOVE))
            leaf_states, _ = step(par_state, leaf_action)
            leaf_terminal = is_game_over(leaf_states) & want
            leaf_new = want & ~leaf_terminal
            leaf_legal = legal_mask_batch(leaf_states)

            # MCGS: lanes whose new position is in the table link to its node.
            if mcgs is not None:
                meta_q = mcgs_meta(leaf_states.to_move, leaf_terminal)
                hit, hit_node, ins_slot, has_empty = mcgs_probe(
                    mcgs, L, leaf_states.hash[:, 0], leaf_states.hash[:, 1], meta_q)
                hit = hit & want
            else:
                hit = torch.zeros_like(want)
                hit_node = torch.zeros(W, dtype=torch.long, device=dev)
            # Grouped replicas stopping at the same unexpanded (parent, action)
            # share ONE node: the first such lane allocates, the rest adopt it.
            if group > 1:
                keyb = (alloc_parent * NUM_MOVES + alloc_action).reshape(B, L)
                wantb = want.reshape(B, L)
                eqk = ((keyb[:, :, None] == keyb[:, None, :])
                       & wantb[:, :, None] & wantb[:, None, :])
                leader_rank = (eqk & lane_lt).sum(dim=2).reshape(-1)
                is_leader = want & (leader_rank == 0)
            else:
                is_leader = want
            allocated = is_leader & ~hit
            na = allocated.reshape(B, L).long()
            arank = na.cumsum(dim=1) - na
            new_idx = (tree.next_free.long()[:, None] + arank).reshape(-1)
            leaf_sub = torch.where(hit, hit_node, new_idx)
            if group > 1:
                lead_idx = eqk.to(torch.uint8).argmax(dim=2)  # first matching lane
                lead = lambda v: v.reshape(B, L).gather(1, lead_idx).reshape(-1)
                leaf_sub = torch.where(want, lead(leaf_sub), leaf_sub)
                hit = torch.where(want, lead(hit), hit)
            if mcgs is not None:
                COUNTERS.add("mcgs_hits", hit)
            leaf_node = torch.where(want, leaf_sub, cur.clamp(0, N - 1))
            path_nodes = torch.where(path_nodes == _NEW_MARK, leaf_sub[:, None],
                                     path_nodes)
            link = want | hit
            wp = torch.where(link, alloc_parent, torch.full_like(alloc_parent, spare))
            wa = torch.where(link, alloc_action, torch.zeros_like(alloc_action))
            ln = torch.where(allocated, leaf_node, torch.full_like(leaf_node, spare))

            def put(arr, idx, new, mask):
                old = arr[bw, idx]
                m = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
                arr[bw, idx] = torch.where(m, new.to(arr.dtype), old)

            def put_last(arr, idx, new, mask):
                # put() where lanes may share an index with different values
                old = arr[bw, idx]
                scatter_last(arr.view(-1), bw * arr.shape[1] + idx,
                             torch.where(mask, new.to(arr.dtype), old))

            e_idx = wp * NUM_MOVES + wa
            put_last(tree.children.view(B, N * NUM_MOVES), e_idx, leaf_node, link)
            put(tree.parent, ln, alloc_parent, allocated)
            put(tree.parent_action, ln, alloc_action, allocated)
            put(tree.s_stones, ln, leaf_states.stones, allocated)
            put(tree.s_chain, ln, leaf_states.chain_id, allocated)
            put(tree.s_last5, ln, leaf_states.last_moves, allocated)
            put(tree.s_ko, ln, leaf_states.ko_point, allocated)
            put(tree.s_cpass, ln, leaf_states.consecutive_passes, allocated)
            put(tree.s_hash, ln, leaf_states.hash, allocated)
            put(tree.s_legal, ln, leaf_legal, allocated)
            tree = tree._replace(next_free=tree.next_free
                                 + na.sum(dim=1).to(torch.int32))
            if mcgs is not None:
                mcgs_insert(mcgs, L, ins_slot, leaf_states.hash[:, 0],
                            leaf_states.hash[:, 1], meta_q, new_idx,
                            allocated & has_empty)

        # --- leaf evaluation: one [B * L] NN call; MCGS hits keep the
        # shared node's evaluation ---
        leaf_color = leaf_states.to_move
        root_sign = torch.where(leaf_color == root_color_w, 1.0, -1.0)
        ev = _eval(eval_fn, leaf_states, "leaf")
        util = ev.outcome_value + _leaf_score_utility(
            params, ev.score_est, ev.score_var, root_sign * root_score_w)
        eval_active = leaf_new & valid0 & ~hit
        if use_bias:
            # Local-pattern value correction q_nn - lambda * bias
            # (bias_cache.h Fetch); the node keeps its slot and keys for
            # the end-of-search accumulation.
            libs = point_liberties_batch(leaf_states.stones, leaf_states.chain_id)
            ill_empty = (leaf_states.stones == 0) & ~leaf_legal[:, :NUM_LOCS]
            bh0, bh1, bvalid = local_pattern_keys(
                leaf_states.stones, libs == 1, ill_empty, leaf_states.last_moves,
                leaf_states.to_move)
            bnum, bden, bslot, bcan = bias_probe(bias_table, L, bh0, bh1, bvalid)
            util = util - torch.where(
                bden > 0, params.bias_lambda * bnum / bden.clamp(min=1e-9), 0.0)
            slot_val = torch.where(bcan, bslot, torch.full_like(bslot, -1))
            put_last(tree.bias_slot, ln, slot_val, eval_active)
            put_last(tree.bias_k0, ln, bh0, eval_active)
            put_last(tree.bias_k1, ln, bh1, eval_active)
        _init_nodes(tree, leaf_node, ev, leaf_color, util, eval_active, bw)

        # --- terminal evaluation (EvaluateTerminal, leaf_evaluator.cc:157-188)
        with tracing.span("search.terminal"):
            t_lanes = leaf_terminal & valid0
            if params.terminal_mode == "exact":
                # Benson scoring of the terminal leaves only (the JAX search
                # scores every lane under a lax.cond on any terminal; other
                # lanes' scores are never read).
                idx = _synced("exact_terminal", torch.nonzero, t_lanes).squeeze(1)
                run_terminal = idx.numel() > 0
                if run_terminal:
                    COUNTERS.exact_scored += idx.numel()
                    sbs, sws, _ = score_board(map_state(lambda x: x[idx], leaf_states))
                    bs = torch.zeros(W, device=dev).index_copy(0, idx, sbs)
                    ws = torch.zeros(W, device=dev).index_copy(0, idx, sws)
            else:
                run_terminal = True
                bs, ws = _cheap_scores(leaf_states)
            if run_terminal:
                player = torch.where(leaf_color == BLACK, bs, ws)
                oppv = torch.where(leaf_color == BLACK, ws, bs)
                final_score = player - oppv
                emp_out = torch.where(player > oppv, 1.0, -1.0)
                # Terminal utility uses stddev 0 (leaf_evaluator.cc:177-180).
                emp_q = emp_out + _leaf_score_utility(
                    params, final_score, torch.zeros_like(final_score),
                    root_sign * root_score_w)
                t_active = t_lanes & ~tree.is_terminal[bw, leaf_node]
                lt = torch.where(t_active, leaf_node, torch.full_like(leaf_node, spare))
                put(tree.init_util, lt, emp_q, t_active)
                put(tree.init_outcome, lt, emp_out, t_active)
                put(tree.init_score, lt, final_score, t_active)
                put(tree.color, lt, leaf_color, t_active)
                tree.is_terminal[bw, lt] = tree.is_terminal[bw, lt] | t_active
                tree.evaluated[bw, lt] = tree.evaluated[bw, lt] | t_active

        # --- backprop (Backward, gumbel.cc:738-761); under MCGS a node
        # can have several parents, so edges follow the traversed path ---
        with tracing.span("search.backup"):
            _backup(tree, bw, path_nodes, leaf_node, valid0,
                    path_actions if mcgs is not None else None)
        return tree

    def rerank(tree: Tree, cand_actions, cand_valid, k_r: int):
        """Candidate re-ranking at a round boundary (gumbel.cc:355-366,
        469-471): only the finishing round's top k_r compete."""
        q0 = q_of_children(tree, zeros_b)
        nvis0 = child_visits(tree, zeros_b)
        maxn = nvis0.max(dim=-1).values.float()
        qtransform = (params.c_visit + maxn[:, None]) * params.c_scale * q0
        scores = (base_score + qtransform).gather(1, cand_actions)
        scores = torch.where(cand_valid, scores, _BIG_NEG)
        in_round = torch.arange(k, device=dev)[None, :] < k_r
        scores = torch.where(in_round, scores, _BIG_NEG)
        order = torch.sort(-scores, dim=1, stable=True).indices
        return cand_actions.gather(1, order), cand_valid.gather(1, order)

    mcgs = None
    if params.use_mcgs:
        # Table ~2x the node budget (a power of two), seeded with the root
        # (GetOrCreate at search entry, gumbel.cc:426).
        s_tab = 64
        while s_tab < 2 * max_nodes:
            s_tab *= 2
        mcgs = make_mcgs_table(B, s_tab, dev)
        meta_r = mcgs_meta(states.to_move, board_over)
        _, _, slot_r, has_r = mcgs_probe(mcgs, 1, states.hash[:, 0], states.hash[:, 1],
                                         meta_r)
        mcgs_insert(mcgs, 1, slot_r, states.hash[:, 0], states.hash[:, 1], meta_r,
                    zeros_b, has_r)
    if es_enabled:
        lam = params.search_confidence ** (1.0 / num_rounds)
    visits_spent = torch.zeros(B, dtype=torch.int32, device=dev)
    for k_r, v_r in round_specs:
        live_k = cand_valid[:, :k_r] & ~board_over[:, None]
        g = max(1, min(params.visit_group, v_r))
        if not es_enabled:
            full, rem = divmod(v_r, g)
            for g_i, reps in [(g, full)] + ([(rem, 1)] if rem else []):
                for _ in range(reps):
                    with tracing.span("search.sweep", k_r=k_r, group=g_i):
                        tree = one_sweep(tree, k_r, cand_actions, cand_valid, g_i, mcgs=mcgs)
            visits_spent = visits_spent + v_r * live_k.sum(dim=1, dtype=torch.int32)
        else:
            # (budget, check interval, first check), gumbel.cc:397-409; i
            # counts visits per candidate (a sweep advances it by g) and a
            # check runs at the first sweep boundary past each of the
            # reference's check points.
            c = -(-v_r // 4)
            if params.over_search:
                budget, first_check = v_r * 5 // 2, v_r
            else:
                budget, first_check = v_r, c
            ztab = _t_quantile_table(lam / (k_r // 2 + k_r % 2), device=dev)
            dead = ~live_k.any(dim=1)
            stopped = torch.zeros(B, dtype=torch.bool, device=dev)
            i = prev = 0
            while i < budget:
                with tracing.span("search.rerank"):
                    if _sync((stopped | dead).all(), "early_stop"):
                        break
                with tracing.span("search.sweep", k_r=k_r, group=g):
                    tree = one_sweep(tree, k_r, cand_actions, cand_valid, g,
                                     stopped=stopped, mcgs=mcgs)
                visits_spent = visits_spent + g * (live_k & ~stopped[:, None]).sum(
                    dim=1, dtype=torch.int32)
                i += g
                if i >= first_check and i // c > prev // c:
                    with tracing.span("search.rerank"):
                        stop_now = _can_stop_early(tree, cand_actions, cand_valid, k_r,
                                                   base_score, ztab, params)
                        if i < budget:
                            COUNTERS.add("early_stops", stop_now & ~stopped & ~dead)
                        stopped = stopped | stop_now
                prev = i
        with tracing.span("search.rerank"):
            cand_actions, cand_valid = rerank(tree, cand_actions, cand_valid, k_r)

    # --- final improved policy (ComputeRootImprovedPolicy, gumbel.cc:154-175)
    q0 = q_of_children(tree, zeros_b)
    nvis0 = child_visits(tree, zeros_b)
    probs0 = torch.softmax(masked_logp, dim=-1)
    # The root's n is still 1 when the reference computes this, so VMixed
    # short-circuits to init_util (gumbel.cc:68-72, 477-480).
    v_mix = tree.init_util[:, 0]
    visit_advantage = 2.0 * math.log(theoretical_winner_visits + 1.0)
    completed = torch.where(nvis0 > 0, (q0 + 1.1) / 2.2,
                            ((v_mix + 1.1) / 2.2)[:, None])
    logits_improved = masked_logp + (params.c_visit + visit_advantage) \
        * params.c_scale * completed
    pi_improved = torch.softmax(logits_improved, dim=-1)

    # --- move selection ---
    top_candidate = cand_actions[:, 0]
    if tau is None:
        tau_arr = torch.full((B,), params.tau, dtype=torch.float32, device=dev)
        use_sampling = params.tau > 0.0
    else:
        tau_arr = tau.float()
        use_sampling = True
    if use_sampling:
        if sample_gumbel is None:
            sample_gumbel = gumbel((B, NUM_MOVES), generator, dev)
        safe_tau = tau_arr.clamp(min=1e-3)[:, None]
        tempered = torch.where(pi_improved > 0,
                               torch.log(pi_improved.clamp(min=1e-30)) / safe_tau,
                               _BIG_NEG)
        sampled = (sample_gumbel + tempered).argmax(dim=-1)
        mcts_move = torch.where(tau_arr > 0, sampled, top_candidate)
    else:
        mcts_move = top_candidate
    any_valid = cand_valid.any(dim=-1)
    mcts_move = torch.where(any_valid & ~board_over, mcts_move,
                            torch.full_like(mcts_move, PASS_MOVE))

    # --- root stitching (gumbel.cc:510-557) ---
    sel_n = nvis0.gather(1, mcts_move[:, None])[:, 0]
    sel_q = q0.gather(1, mcts_move[:, None])[:, 0]
    sel_child = tree.children[b, 0, mcts_move].long()
    sel_child_s = sel_child.clamp(0, N - 1)
    n_sel = tree.n[b, sel_child_s]
    sel_qz = torch.where(
        sel_child >= 0,
        -torch.where(n_sel > 0, tree.w_outcome[b, sel_child_s] / n_sel.clamp(min=1),
                     -1.0),
        -1.0)
    n_root = tree.n[:, 0].clamp(min=1).float()
    v_pre = tree.w[:, 0] / n_root
    vz_pre = tree.w_outcome[:, 0] / n_root
    total = n_root + sel_n.float()
    root_value = (n_root * v_pre + sel_n * sel_q) / total
    root_outcome = (n_root * vz_pre + sel_n * sel_qz) / total
    child_hist = tree.v_categorical[b, sel_child_s]
    root_value_dist = tree.v_categorical[:, 0, :] + torch.where(
        (sel_child >= 0)[:, None], child_hist.flip(-1), torch.zeros_like(child_hist))

    eps = 1e-10
    kld = torch.where(pi_improved > 0,
                      pi_improved * (torch.log(pi_improved + eps)
                                     - torch.log(probs0 + eps)), 0.0).sum(dim=-1)

    result = GumbelResult(
        mcts_move=mcts_move, raw_nn_move=raw_nn_move, pi_improved=pi_improved,
        root_value=root_value, root_outcome=root_outcome,
        root_score_est=root_score_est, q_selected=sel_q, qz_selected=sel_qz,
        kld=kld, visits=visits_spent, root_child_visits=nvis0,
        root_priors=probs0, root_value_dist=root_value_dist, root_child_q=q0)
    if use_bias:
        # End-of-search accumulation (UpdateAndFetch telescoped,
        # bias_cache.h:155-185): obs_err = init_util + sum(edge_w)/(n-1)
        # (edge sums are child-perspective), weight = (n-1)^alpha; per-node
        # deltas against the last contributed terms keep tree reuse exact.
        nm1 = (tree.n - 1).float()
        upd = (tree.bias_slot >= 0) & (tree.n >= 2) & tree.evaluated
        obs_err = tree.init_util + tree.edge_w.sum(dim=-1) / nm1.clamp(min=1.0)
        w_term = nm1.clamp(min=0.0) ** params.bias_alpha
        obs_term = obs_err * w_term
        d_err = torch.where(upd, obs_term - tree.bias_obs_last, 0.0)
        d_w = torch.where(upd, w_term - tree.bias_w_last, 0.0)
        bias_table = bias_accumulate(bias_table, tree.bias_slot, upd, tree.bias_k0,
                                     tree.bias_k1, d_err, d_w)
        tree.bias_obs_last.copy_(torch.where(upd, obs_term, tree.bias_obs_last))
        tree.bias_w_last.copy_(torch.where(upd, w_term, tree.bias_w_last))
    return finish(result)


class RootPreStats(NamedTuple):
    """Pre-search root statistics of a reused tree
    (self_play_thread.cc:459-482)."""

    n_pre: torch.Tensor  # int32[B]
    q_pre: torch.Tensor  # f32[B]
    qz_pre: torch.Tensor  # f32[B]
    std_pre: torch.Tensor  # f32[B]
    pre_kld: torch.Tensor  # f32[B]
    nn_q: torch.Tensor  # f32[B]
    qz_nn: torch.Tensor  # f32[B]
    nn_mcts_diff: torch.Tensor  # f32[B]
    q_canonical: torch.Tensor  # f32[B]
    nn_uncertainty: torch.Tensor  # f32[B]
    prior_entropy: torch.Tensor  # f32[B]


def root_pre_stats(tree: Tree, c_visit: float = 50.0,
                   c_scale: float = 1.0) -> RootPreStats:
    """Pre-search root stats of a (reused) tree; every signal is zero for
    fresh roots (self_play_thread.cc:459-482)."""
    n_pre = tree.n[:, 0]
    nf = n_pre.clamp(min=1).float()
    q_pre = torch.where(n_pre > 0, tree.w[:, 0] / nf, 0.0)
    qz_pre = torch.where(n_pre > 0, tree.w_outcome[:, 0] / nf, 0.0)
    var_pre = torch.where(n_pre >= 3, tree.vz_var_sum[:, 0] / nf, 0.0)
    pi_pre = _completed_q_policy(tree.log_priors[:, 0].float(),
                                 tree.edge_n[:, 0], tree.edge_w[:, 0], n_pre,
                                 tree.init_util[:, 0], c_visit, c_scale)
    priors = torch.softmax(tree.log_priors[:, 0, :].float(), dim=-1)
    eps = 1e-10
    kld = torch.where(pi_pre > 0, pi_pre * (torch.log(pi_pre + eps)
                                            - torch.log(priors + eps)),
                      0.0).sum(dim=-1)
    pre_kld = torch.where(n_pre >= 1, kld, 0.0)
    nn_q = tree.init_util[:, 0]
    qz_nn = tree.init_outcome[:, 0]
    nn_mcts_diff = torch.where(n_pre > 0, (qz_nn - q_pre).abs(), 0.0)
    q_canonical = torch.where(qz_pre == 0.0, qz_nn, qz_pre)
    entropy = -torch.where(priors > 0, priors * torch.log(priors + eps),
                           0.0).sum(dim=-1)
    entropy = torch.where(tree.evaluated[:, 0], entropy, 0.0)
    return RootPreStats(
        n_pre=n_pre, q_pre=q_pre, qz_pre=qz_pre,
        std_pre=torch.sqrt(var_pre.clamp(min=0.0)),
        pre_kld=pre_kld, nn_q=nn_q, qz_nn=qz_nn, nn_mcts_diff=nn_mcts_diff,
        q_canonical=q_canonical, nn_uncertainty=tree.init_err[:, 0],
        prior_entropy=entropy)
