"""Batched PUCT search (port of p3achygo_tpu/mcts/puct.py; mirrors
GumbelEvaluator::SearchRootPuct, gumbel.cc:563-666, and PuctScorer,
search_policy.h:133-330).

PUCT action selection at every node of the descent, with:
- c_puct log visit scaling: c + 0.45 * log((n + 500) / 500)
  (search_policy.h:151-157)
- FPU reduction by explored prior mass: v_fpu = v - fpu * sqrt(p_explored)
  (search_policy.h:214-224, kDefaultFPU = 0.2)
- optional per-child variance scaling of c_puct (search_policy.h:256-269),
  PUCT-V and the M3 bonus (search_policy.h:277-312)
- root move selection by visit count / best LCB / tempered sample
  (gumbel.cc:628-645); LCB = Q - z * sqrt(QVar / n) with the normal z.

One simulation per board per iteration, so `n` network calls per move. The
descent replays moves on scratch boards without history (`strip_history`)
and takes legality from `legal_mask_batch`, which runs the liberty kernel
on the card. Tree rows are read by indexing and the backup accumulates with
`index_add_`. The sample draw of root_selection="sample" comes from
`generator` or is passed in (`sample_gumbel`, Gumbel-max as JAX's
`categorical`). The backup is the Gumbel search's (`gumbel._backup`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from p3achygo_tpu_torch import tracing
from p3achygo_tpu_torch.constants import BLACK, NUM_MOVES, PASS_MOVE
from p3achygo_tpu_torch.game.board import (
    GoState,
    is_game_over,
    legal_mask_batch,
    map_state,
    select_state,
    step,
    strip_history,
)
from p3achygo_tpu_torch.game.scoring import score as score_board
from p3achygo_tpu_torch.mcts.gumbel import (
    _BIG_NEG,
    _NEW_MARK,
    COUNTERS,
    EvalFn,
    GumbelResult,
    _backup,
    _cheap_scores,
    _eval,
    _init_nodes,
    _leaf_score_utility,
    _sync,
    _synced,
    gumbel,
)
from p3achygo_tpu_torch.mcts.tree import (
    Tree,
    child_visits,
    make_tree,
    q_nvis_of_children,
    q_of_children,
)


@dataclasses.dataclass(frozen=True)
class PuctParams:
    """Mirrors mcts::PuctParams (search_policy.h:24-50)."""

    n: int = 64
    c_puct: float = 1.0
    c_puct_visit_scaling: float = 0.45
    fpu: float = 0.2  # kDefaultFPU
    root_fpu: float = 0.2
    enable_var_scaling: bool = False
    var_scale_prior_visits: int = 4
    root_selection: str = "visit_count"  # visit_count | lcb | sample
    tau: float = 0.0
    lcb_z: float = 1.96
    max_depth: int = 32
    score_weight: float = 0.5
    # "direct" | "integral" (ScoreUtilityMode, leaf_evaluator.h:12-16).
    score_utility_mode: str = "direct"
    terminal_mode: str = "cheap"
    # Experimental variants (search_policy.h:24-50):
    # PUCT-V (search_policy.h:292-312): exploration scaled by the child's
    # value stddev plus a log-visit term weighted by c_puct_v_2.
    use_puct_v: bool = False
    c_puct_v_2: float = 3.0
    # M3/skewness bonus (search_policy.h:277-290): children with a larger
    # positive value tail than the visit-weighted average get a bonus that
    # decays with visits (dampened by m3_prior_visits).
    enable_m3_bonus: bool = False
    m3_prior_visits: int = 20
    # Optimistic-policy interpolation (search_policy.h:171-185): the tree
    # stores one prior set, so the blend happens at eval time —
    # make_eval_fn(p_opt_weight=...). Kept here for config parity.
    p_opt_weight: float = 0.0


def _puct_action(tree: Tree, node: torch.Tensor, legal: torch.Tensor,
                 p: PuctParams, is_root: torch.Tensor) -> torch.Tensor:
    """Vectorized PuctScorer::ComputeScores + TopMove over one node per
    board: node int64[B], legal bool[B, 362] -> int64[B]."""
    B, N = tree.n.shape
    b = torch.arange(B, device=node.device)
    probs = torch.exp(tree.log_priors[b, node].float())
    q, nvis = (t[:, 0] for t in q_nvis_of_children(tree, node[:, None]))
    visited = nvis > 0
    n_i = tree.n[b, node]
    n = n_i.float()
    v = torch.where(n_i > 0, tree.w[b, node] / n_i.clamp(min=1), tree.init_util[b, node])

    p_explored = torch.where(visited, probs, 0.0).sum(dim=-1)
    fpu = torch.where(is_root, p.root_fpu, p.fpu)
    v_fpu = v - fpu * torch.sqrt(p_explored)

    def scale_cpuct(c):  # ScaleCPuct (search_policy.h:150-157)
        return c + p.c_puct_visit_scaling * torch.log((n + 500.0) / 500.0)

    c_puct = scale_cpuct(p.c_puct)
    canonical_n = 1.0 + nvis.sum(dim=-1).float()

    if p.enable_var_scaling or p.use_puct_v or p.enable_m3_bonus:
        safe = tree.children[b, node].long().clamp(0, N - 1)
        kid_n = tree.n[b[:, None], safe].float()
        kid_var = torch.where(kid_n > 0, tree.v_var_sum[b[:, None], safe]
                              / kid_n.clamp(min=1), 0.0)
        kid_std = torch.sqrt(kid_var.clamp(min=0.0))

    scale = 1.0
    if p.enable_var_scaling:
        std_mean = torch.where(nvis >= 3, kid_std * nvis, 0.0).sum(dim=-1) / n.clamp(min=1.0)
        pw = float(p.var_scale_prior_visits)
        scale = torch.where(
            (nvis >= 3) & (std_mean[:, None] > 0),
            (pw + nvis * (kid_std / std_mean[:, None].clamp(min=1e-10))) / (pw + nvis),
            1.0)

    if p.use_puct_v:
        parent_var = torch.where(n > 0, tree.v_var_sum[b, node] / n.clamp(min=1.0), 0.0)
        fallback = torch.where(n < 3, 1.0, parent_var)[:, None]
        var_a = torch.where(nvis >= 3, kid_var.clamp(min=0.0), fallback)
        std_a = torch.sqrt(var_a.clamp(min=0.0))
        c_puct_v2 = scale_cpuct(p.c_puct_v_2)
        var_scale_term = probs * std_a * (torch.sqrt(canonical_n)[:, None] / (1.0 + nvis))
        n_scale_term = probs * (torch.log(canonical_n)[:, None] / (1.0 + nvis))
        explore = c_puct[:, None] * var_scale_term + c_puct_v2[:, None] * n_scale_term
    else:
        explore = (c_puct[:, None] * scale * probs
                   * (torch.sqrt(canonical_n)[:, None] / (1.0 + nvis)))

    m3_bonus = 0.0
    if p.enable_m3_bonus:
        kid_m3 = torch.where(kid_n > 0, tree.v_m3_sum[b[:, None], safe]
                             / kid_n.clamp(min=1), 0.0)
        q_m3 = -kid_m3
        m3_std = torch.sign(q_m3) * torch.abs(q_m3) ** (1.0 / 3.0)
        m3_std_mean = torch.where(nvis >= 3, m3_std * nvis, 0.0).sum(dim=-1) \
            / n.clamp(min=1.0)
        pm = float(p.m3_prior_visits)
        m3_bonus = torch.where(nvis >= 3, (pm + (m3_std - m3_std_mean[:, None])) / (pm + nvis),
                               0.0)

    canonical_q = torch.where(visited, q, v_fpu[:, None])
    scores = explore + canonical_q + m3_bonus
    return torch.where(legal, scores, _BIG_NEG).argmax(dim=-1)


def search_root_puct(states: GoState, eval_fn: EvalFn, p: PuctParams,
                     generator: Optional[torch.Generator] = None,
                     return_tree: bool = False,
                     sample_gumbel: Optional[torch.Tensor] = None):
    """PUCT root search on a batch of boards -> GumbelResult, spanned as
    `search.root` (n = visits, k = 0).

    `return_tree=True` also stores each new node's board state in the tree
    (the s_* fields, otherwise skipped because the descent replays moves on
    scratch boards) and returns (result, tree), so the tree can seed a
    Gumbel search (tree.compact_root -> gumbel.search_root(init_tree=...)),
    as the reference's visit study does (gumbel_visits_study.cc
    RunSeededGumbel)."""
    with tracing.span("search.root", n=p.n, k=0, rows=states.stones.shape[0]):
        return _search_root_puct(states, eval_fn, p, generator, return_tree, sample_gumbel)


def _search_root_puct(states: GoState, eval_fn: EvalFn, p: PuctParams, generator,
                      return_tree: bool, sample_gumbel):
    COUNTERS.searches += 1
    B = states.stones.shape[0]
    dev = states.stones.device
    b = torch.arange(B, device=dev)
    N = max_nodes = p.n + 2
    tree = make_tree(B, max_nodes, dev)
    spare = max_nodes - 1
    zeros_b = torch.zeros(B, dtype=torch.long, device=dev)

    root_ev = _eval(eval_fn, states, "root")
    root_color = states.to_move
    _init_nodes(tree, zeros_b, root_ev, root_color, root_ev.outcome_value,
                torch.ones(B, dtype=torch.bool, device=dev), b)
    tree.n[:, 0] = 1
    tree.w[:, 0] = root_ev.outcome_value
    tree.w_outcome[:, 0] = root_ev.outcome_value
    root_score_est = root_ev.score_est
    legal0 = legal_mask_batch(states)
    if return_tree:
        tree.s_stones[:, 0] = states.stones
        tree.s_chain[:, 0] = states.chain_id.to(torch.int16)
        tree.s_last5[:, 0] = states.last_moves.to(torch.int16)
        tree.s_ko[:, 0] = states.ko_point.to(torch.int16)
        tree.s_cpass[:, 0] = states.consecutive_passes.to(torch.int8)
        tree.s_hash[:, 0] = states.hash
        tree.s_legal[:, 0] = legal0
    board_over = is_game_over(states)
    raw_nn_move = root_ev.log_priors.argmax(dim=-1)
    scratch_base = strip_history(states)
    valid0 = ~board_over
    D = p.max_depth

    def put(arr, idx, new, mask):
        old = arr[b, idx]
        m = mask.reshape(mask.shape + (1,) * (old.dim() - 1))
        arr[b, idx] = torch.where(m, new.to(arr.dtype), old)

    for _ in range(p.n):
        # --- descent: PUCT at every node, on a scratch board; the tree is
        # read-only until the leaf (one allocation per simulation) ---
        scratch = scratch_base
        cur = torch.zeros(B, dtype=torch.long, device=dev)
        depth = torch.zeros(B, dtype=torch.long, device=dev)
        done = ~valid0
        path_nodes = torch.full((B, D), -1, dtype=torch.long, device=dev)
        path_actions = torch.zeros((B, D), dtype=torch.long, device=dev)
        leaf_new = torch.zeros(B, dtype=torch.bool, device=dev)
        leaf_terminal = torch.zeros(B, dtype=torch.bool, device=dev)
        alloc_parent = torch.full((B,), spare, dtype=torch.long, device=dev)
        alloc_action = torch.zeros(B, dtype=torch.long, device=dev)
        while not _sync(done.all(), "puct_descent"):
            active = ~done
            node = cur.clamp(0, N - 1)
            a = _puct_action(tree, node, legal_mask_batch(scratch), p, depth == 0)
            new_scratch, _ = step(scratch, a)
            scratch = select_state(active, new_scratch, scratch)
            child = tree.children[b, node, a].long()
            need_alloc = (child < 0) & active
            child_idx = torch.where(need_alloc, torch.full_like(child, _NEW_MARK), child)
            alloc_parent = torch.where(need_alloc, node, alloc_parent)
            alloc_action = torch.where(need_alloc, a, alloc_action)
            terminal_board = is_game_over(scratch) & active
            known_terminal = (child >= 0) & tree.is_terminal[b, child_idx.clamp(0, N - 1)]
            stop = (need_alloc | terminal_board | known_terminal) & active
            d = depth.clamp(max=D - 1)
            path_nodes[b, d] = torch.where(active, child_idx, path_nodes[b, d])
            path_actions[b, d] = torch.where(active, a, path_actions[b, d])
            leaf_new = leaf_new | (stop & need_alloc & ~terminal_board)
            leaf_terminal = leaf_terminal | (stop & terminal_board)
            cur = torch.where(active, child_idx, cur)
            depth = depth + active.long()
            done = done | stop | (depth >= D)
        leaf_states = scratch

        allocated = (cur == _NEW_MARK) & valid0
        new_idx = tree.next_free.long()
        leaf_node = torch.where(allocated, new_idx, cur.clamp(0, N - 1))
        path_nodes = torch.where(path_nodes == _NEW_MARK, new_idx[:, None], path_nodes)
        wp = torch.where(allocated, alloc_parent, torch.full_like(alloc_parent, spare))
        wa = torch.where(allocated, alloc_action, torch.zeros_like(alloc_action))
        ln = torch.where(allocated, leaf_node, torch.full_like(leaf_node, spare))
        old_child = tree.children[b, wp, wa]
        tree.children[b, wp, wa] = torch.where(allocated, leaf_node.to(old_child.dtype),
                                               old_child)
        put(tree.parent, ln, alloc_parent, allocated)
        put(tree.parent_action, ln, alloc_action, allocated)
        tree = tree._replace(next_free=tree.next_free + allocated.to(torch.int32))
        if return_tree:
            put(tree.s_stones, ln, leaf_states.stones, allocated)
            put(tree.s_chain, ln, leaf_states.chain_id, allocated)
            put(tree.s_last5, ln, leaf_states.last_moves, allocated)
            put(tree.s_ko, ln, leaf_states.ko_point, allocated)
            put(tree.s_cpass, ln, leaf_states.consecutive_passes, allocated)
            put(tree.s_hash, ln, leaf_states.hash, allocated)
            put(tree.s_legal, ln, legal_mask_batch(leaf_states), allocated)

        leaf_color = leaf_states.to_move
        root_sign = torch.where(leaf_color == root_color, 1.0, -1.0)
        ev = _eval(eval_fn, leaf_states, "leaf")
        util = ev.outcome_value + _leaf_score_utility(
            p, ev.score_est, ev.score_var, root_sign * root_score_est)
        _init_nodes(tree, leaf_node, ev, leaf_color, util, leaf_new & valid0, b)

        # --- terminal evaluation (EvaluateTerminal, leaf_evaluator.cc:157-188)
        t_lanes = leaf_terminal & valid0
        run_terminal = True
        if p.terminal_mode == "exact":
            idx = _synced("exact_terminal", torch.nonzero, t_lanes).squeeze(1)
            run_terminal = idx.numel() > 0
            if run_terminal:
                COUNTERS.exact_scored += idx.numel()
                sbs, sws, _ = score_board(map_state(lambda x: x[idx], leaf_states))
                bs = torch.zeros(B, device=dev).index_copy(0, idx, sbs)
                ws = torch.zeros(B, device=dev).index_copy(0, idx, sws)
        else:
            bs, ws = _cheap_scores(leaf_states)
        if run_terminal:
            player = torch.where(leaf_color == BLACK, bs, ws)
            oppv = torch.where(leaf_color == BLACK, ws, bs)
            final_score = player - oppv
            emp_out = torch.where(player > oppv, 1.0, -1.0)
            emp_q = emp_out + _leaf_score_utility(
                p, final_score, torch.zeros_like(final_score), root_sign * root_score_est)
            t_active = t_lanes & ~tree.is_terminal[b, leaf_node]
            lt = torch.where(t_active, leaf_node, torch.full_like(leaf_node, spare))
            put(tree.init_util, lt, emp_q, t_active)
            put(tree.init_outcome, lt, emp_out, t_active)
            put(tree.init_score, lt, final_score, t_active)
            put(tree.color, lt, leaf_color, t_active)
            tree.is_terminal[b, lt] = tree.is_terminal[b, lt] | t_active
            tree.evaluated[b, lt] = tree.evaluated[b, lt] | t_active

        # --- backup along the path (edges by the traversed actions) and
        # into the root: SearchRootPuct paths start at the root,
        # first_is_root=true (gumbel.cc:604-609) ---
        leaf_q = tree.init_util[b, leaf_node]
        leaf_qz = tree.init_outcome[b, leaf_node]
        root_sign_v = torch.where(tree.color[:, 0] == tree.color[b, leaf_node], 1.0, -1.0)
        _backup(tree, b, path_nodes, leaf_node, valid0, path_actions)
        tree.n[:, 0] += valid0.to(torch.int32)
        tree.w[:, 0] += torch.where(valid0, root_sign_v * leaf_q, 0.0)
        tree.w_outcome[:, 0] += torch.where(valid0, root_sign_v * leaf_qz, 0.0)
    visits_spent = valid0.to(torch.int32) * p.n

    # Improved policy = visit-count distribution (gumbel.cc:617-627).
    nvis0 = child_visits(tree, zeros_b)
    total = nvis0.sum(dim=-1).clamp(min=1).float()
    pi_improved = nvis0.float() / total[:, None]
    q0 = q_of_children(tree, zeros_b)

    if p.root_selection == "lcb":
        kids = tree.children[:, 0, :].long()
        safe = kids.clamp(0, N - 1)
        kid_n = tree.n[b[:, None], safe].float()
        kid_var = torch.where(kid_n > 0, tree.v_var_sum[b[:, None], safe]
                              / kid_n.clamp(min=1), 0.0)
        lcb = torch.where((kids >= 0) & (kid_n >= 2),
                          q0 - p.lcb_z * torch.sqrt(kid_var.clamp(min=0.0) / kid_n.clamp(min=1)),
                          -1e6 + kid_n)
        mcts_move = torch.where(legal0, lcb, _BIG_NEG).argmax(dim=-1)
    elif p.root_selection == "sample" and p.tau > 0:
        if sample_gumbel is None:
            sample_gumbel = gumbel((B, NUM_MOVES), generator, dev)
        logits = torch.where(pi_improved > 0,
                             torch.log(pi_improved.clamp(min=1e-30)) / p.tau, _BIG_NEG)
        mcts_move = (sample_gumbel + logits).argmax(dim=-1)
    else:
        mcts_move = torch.where(legal0, nvis0.float(), _BIG_NEG).argmax(dim=-1)
    mcts_move = torch.where(board_over, torch.full_like(mcts_move, PASS_MOVE), mcts_move)

    sel_n = nvis0.gather(1, mcts_move[:, None])[:, 0]
    sel_q = q0.gather(1, mcts_move[:, None])[:, 0]
    n_root = tree.n[:, 0]
    root_v = torch.where(n_root > 0, tree.w[:, 0] / n_root.clamp(min=1), root_ev.outcome_value)
    root_vz = torch.where(n_root > 0, tree.w_outcome[:, 0] / n_root.clamp(min=1),
                          root_ev.outcome_value)
    eps = 1e-10
    probs0 = torch.softmax(torch.where(legal0, root_ev.log_priors, _BIG_NEG), dim=-1)
    kld = torch.where(pi_improved > 0,
                      pi_improved * (torch.log(pi_improved + eps) - torch.log(probs0 + eps)),
                      0.0).sum(dim=-1)
    result = GumbelResult(
        mcts_move=mcts_move, raw_nn_move=raw_nn_move, pi_improved=pi_improved,
        root_value=root_v, root_outcome=root_vz, root_score_est=root_score_est,
        q_selected=sel_q, qz_selected=torch.where(sel_n > 0, sel_q, -1.0),
        kld=kld, visits=visits_spent, root_child_visits=nvis0, root_priors=probs0,
        root_value_dist=tree.v_categorical[:, 0, :], root_child_q=q0)
    if return_tree:
        return result, tree
    return result
