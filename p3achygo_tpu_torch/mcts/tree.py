"""Array-of-nodes search tree, batched over boards (port of
p3achygo_tpu/mcts/tree.py without the MCGS table and the value-bias
fields).

Replaces the reference's pointer tree (cc/mcts/tree.h TreeNode) with
preallocated [B, N, ...] tensors; each simulation allocates at most one
node. Sign conventions follow tree.h:95-162: `w`/`v` are from the
perspective of the player to move at that node; Q(parent, a) = -v[child];
missing children read as MIN_Q.

Child statistics are kept edge-indexed (`edge_n`/`edge_w`, [B, N, 362]) as
in the JAX tree, and every node stores its board at creation so descents
never step a board. Field dtypes are the JAX tree's (int16 children and
edge counts, bf16 log-priors): the rounding of bf16 priors is part of
search semantics. The hash lanes are int64 holding uint32 values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from p3achygo_tpu_torch.constants import NUM_LOCS, NUM_MOVES, NUM_V_BUCKETS

# Q bounds (cc/mcts/constants.h:6-11).
MIN_Q = -1.5
MAX_Q = 1.5
V_BUCKET_RANGE = 2.0 / NUM_V_BUCKETS

NO_CHILD = -1

# int16 edge_n saturation ceiling: adds clamp here instead of wrapping.
EDGE_N_MAX = 2**15 - 1


def saturating_edge_add(edge_n: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """edge_n + inc clamped to EDGE_N_MAX, in edge_n's dtype."""
    s = edge_n.to(torch.int32) + inc.to(torch.int32)
    return torch.clamp(s, max=EDGE_N_MAX).to(edge_n.dtype)


class Tree(NamedTuple):
    """Batched node arrays, B leading, N = max nodes."""

    n: torch.Tensor  # int32[B, N] visit count
    w: torch.Tensor  # f32[B, N] summed utility (own perspective)
    w_outcome: torch.Tensor  # f32[B, N] summed outcome value
    score_sum: torch.Tensor  # f32[B, N]
    v_var_sum: torch.Tensor  # f32[B, N] n * Var(v)
    vz_var_sum: torch.Tensor  # f32[B, N] n * Var(v_outcome)
    v_m3_sum: torch.Tensor  # f32[B, N] n * M3(v)
    init_util: torch.Tensor  # f32[B, N]
    init_outcome: torch.Tensor  # f32[B, N]
    init_score: torch.Tensor  # f32[B, N]
    init_err: torch.Tensor  # f32[B, N]
    log_priors: torch.Tensor  # bf16[B, N, 362]
    children: torch.Tensor  # int16[B, N, 362] node index or -1
    edge_n: torch.Tensor  # int16[B, N, 362]
    edge_w: torch.Tensor  # f32[B, N, 362]
    edge_wz: torch.Tensor  # f32[B, N, 362]
    color: torch.Tensor  # int8[B, N] player to move at node
    is_terminal: torch.Tensor  # bool[B, N]
    evaluated: torch.Tensor  # bool[B, N]
    next_free: torch.Tensor  # int32[B] allocation cursor
    v_categorical: torch.Tensor  # int32[B, N, 51] outcome-value histogram
    parent: torch.Tensor  # int32[B, N] allocation parent (-1 root/unset)
    parent_action: torch.Tensor  # int32[B, N]
    s_stones: torch.Tensor  # int8[B, N, 361] stored node board
    s_chain: torch.Tensor  # int16[B, N, 361]
    s_last5: torch.Tensor  # int16[B, N, 5]
    s_ko: torch.Tensor  # int16[B, N]
    s_cpass: torch.Tensor  # int8[B, N]
    s_hash: torch.Tensor  # int64[B, N, 2]
    s_legal: torch.Tensor  # bool[B, N, 362]


def make_tree(batch_size: int, max_nodes: int, device="cuda") -> Tree:
    B, N = batch_size, max_nodes
    if max_nodes >= 2**15:
        raise ValueError(f"max_nodes={max_nodes} >= 2**15 would overflow "
                         "int16 child indices")
    dev = torch.device(device)
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype,
                                                        device=dev)
    f = lambda v, *shape, dtype: torch.full(shape, v, dtype=dtype, device=dev)
    return Tree(
        n=z(B, N, dtype=torch.int32),
        w=z(B, N), w_outcome=z(B, N), score_sum=z(B, N), v_var_sum=z(B, N),
        vz_var_sum=z(B, N), v_m3_sum=z(B, N),
        init_util=z(B, N), init_outcome=z(B, N), init_score=z(B, N),
        init_err=z(B, N),
        log_priors=z(B, N, NUM_MOVES, dtype=torch.bfloat16),
        children=f(NO_CHILD, B, N, NUM_MOVES, dtype=torch.int16),
        edge_n=z(B, N, NUM_MOVES, dtype=torch.int16),
        edge_w=z(B, N, NUM_MOVES),
        edge_wz=z(B, N, NUM_MOVES),
        color=z(B, N, dtype=torch.int8),
        is_terminal=z(B, N, dtype=torch.bool),
        evaluated=z(B, N, dtype=torch.bool),
        next_free=f(1, B, dtype=torch.int32),  # slot 0 = root
        v_categorical=z(B, N, NUM_V_BUCKETS, dtype=torch.int32),
        parent=f(-1, B, N, dtype=torch.int32),
        parent_action=z(B, N, dtype=torch.int32),
        s_stones=z(B, N, NUM_LOCS, dtype=torch.int8),
        s_chain=f(-1, B, N, NUM_LOCS, dtype=torch.int16),
        s_last5=f(-1, B, N, 5, dtype=torch.int16),
        s_ko=f(-1, B, N, dtype=torch.int16),
        s_cpass=z(B, N, dtype=torch.int8),
        s_hash=z(B, N, 2, dtype=torch.int64),
        s_legal=z(B, N, NUM_MOVES, dtype=torch.bool),
    )


def rows_by_node(arr: torch.Tensor, node_bk: torch.Tensor) -> torch.Tensor:
    """Per-node rows: arr [B, N, A] + node [B, k] -> float32 [B, k, A]."""
    b = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[b, node_bk.long()].float()


def node_v(tree: Tree, node: torch.Tensor) -> torch.Tensor:
    """Mean utility of node [B] (own perspective); MIN_Q when unvisited."""
    b = torch.arange(tree.n.shape[0], device=node.device)
    n = tree.n[b, node.long()]
    return torch.where(n > 0, tree.w[b, node.long()] / n.clamp(min=1),
                       torch.full_like(tree.w[:, 0], MIN_Q))


def q_nvis_of_children(tree: Tree, node_bk: torch.Tensor):
    """node_bk [B, k] -> (q f32[B, k, 362], nvis int32[B, k, 362]) from edge
    stats; Q = -edge_w/edge_n (tree.h:118-123), MIN_Q where unvisited."""
    en = rows_by_node(tree.edge_n, node_bk)
    ew = rows_by_node(tree.edge_w, node_bk)
    nvis = en.to(torch.int32)
    q = torch.where(nvis > 0, -(ew / en.clamp(min=1.0)),
                    torch.full_like(ew, MIN_Q))
    return q, nvis


def q_of_children(tree: Tree, node: torch.Tensor) -> torch.Tensor:
    """[B, 362] Q(node, a) for one node per board."""
    return q_nvis_of_children(tree, node[:, None])[0][:, 0]


def child_visits(tree: Tree, node: torch.Tensor) -> torch.Tensor:
    """[B, 362] visit counts of one node's children per board."""
    return q_nvis_of_children(tree, node[:, None])[1][:, 0]


def welford_m3_delta(q, v_old, n_new, m2_old, dvar):
    """Pébay online third-central-moment increment (see the JAX tree):
    delta_n = (q - v_old) / n_new; dM3 = dvar*delta_n*(n_new-2) - 3*delta_n*m2_old."""
    delta_n = (q - v_old) / torch.clamp(n_new, min=1.0)
    return dvar * delta_n * (n_new - 2.0) - 3.0 * delta_n * m2_old


def compact_subtree(tree: Tree, action: torch.Tensor, capacity: int) -> Tree:
    """The subtree under root's child `action` [B] as a fresh tree of
    `capacity` slots (tree reuse, self_play_thread.cc:709-727). Boards whose
    action has no child get an empty tree."""
    B = tree.n.shape[0]
    b = torch.arange(B, device=action.device)
    new_root = tree.children[b, 0, action.long()].to(torch.int64)
    return _compact(tree, new_root, capacity)


def compact_root(tree: Tree, capacity: int) -> Tree:
    """Compact the whole tree (root stays root) into `capacity` slots; the
    root's n/w/w_outcome are rebuilt from its out-edges (see the JAX
    tree.compact_root)."""
    B = tree.n.shape[0]
    out = _compact(tree, torch.zeros(B, dtype=torch.int64,
                                     device=tree.n.device), capacity)
    ev = out.evaluated[:, 0]
    n0 = 1 + out.edge_n[:, 0, :].float().sum(dim=-1).to(torch.int32)
    w0 = out.init_util[:, 0] - out.edge_w[:, 0, :].sum(dim=-1)
    wz0 = out.init_outcome[:, 0] - out.edge_wz[:, 0, :].sum(dim=-1)
    out.n[:, 0] = torch.where(ev, n0, out.n[:, 0])
    out.w[:, 0] = torch.where(ev, w0, out.w[:, 0])
    out.w_outcome[:, 0] = torch.where(ev, wz0, out.w_outcome[:, 0])
    return out


def _reachable(parent: torch.Tensor, new_root: torch.Tensor) -> torch.Tensor:
    """bool[B, N]: node m is new_root or has it as an ancestor. Pointer
    doubling over the parent table (parents precede children)."""
    B, N = parent.shape
    dev = parent.device
    # Sentinel node N: unreachable, its own parent.
    up = torch.cat([parent.long(), torch.full((B, 1), -1, dtype=torch.long,
                                              device=dev)], dim=1)
    up = torch.where(up < 0, torch.full_like(up, N), up)
    idx = torch.arange(N + 1, device=dev)[None]
    reach = (idx == new_root[:, None]) & (idx < N)
    span = 1
    while span <= N:
        reach = reach | reach.gather(1, up)
        up = up.gather(1, up)
        span *= 2
    return reach[:, :N]


def _compact(tree: Tree, new_root: torch.Tensor, capacity: int) -> Tree:
    """Copy the nodes reachable from new_root, in slot order, into rows
    0..capacity-1 of a new tree; rows without a source read 0 (children
    and parent read -1), exactly as the JAX one-hot compaction."""
    B, N = tree.n.shape
    dev = tree.n.device
    C = capacity
    reachable = _reachable(tree.parent, new_root)
    new_idx = torch.where(reachable, reachable.long().cumsum(dim=1) - 1,
                          torch.full_like(new_root[:, None], -1))
    num = reachable.sum(dim=1, dtype=torch.int32)

    # src[b, r] = old slot copied into row r, or -1.
    dst = torch.where(reachable & (new_idx < C), new_idx, torch.full_like(new_idx, C))
    src = torch.full((B, C + 1), -1, dtype=torch.long, device=dev)
    src.scatter_(1, dst, torch.arange(N, device=dev).expand(B, N))
    src = src[:, :C]
    has = src >= 0
    src_c = src.clamp(min=0)

    def rows(arr: torch.Tensor) -> torch.Tensor:
        idx = src_c.reshape((B, C) + (1,) * (arr.dim() - 2)).expand(
            (B, C) + arr.shape[2:])
        out = arr.gather(1, idx)
        mask = has.reshape((B, C) + (1,) * (arr.dim() - 2))
        return torch.where(mask, out, torch.zeros_like(out))

    # Parent remap (the new root's parent -> -1).
    par_rows = rows(torch.where(tree.parent < 0, N, tree.parent).to(torch.long))
    cand = new_idx.gather(1, par_rows.clamp(max=N - 1))
    parent_new = torch.where((par_rows < N) & (cand >= 0), cand,
                             torch.full_like(cand, -1))
    parent_new[:, 0] = -1
    action_rows = rows(tree.parent_action)
    compact_reach = rows(reachable.to(torch.int32)) > 0

    # Rebuild children from (parent_new, action) of rows 1..C-1.
    is_child = compact_reach & (torch.arange(C, device=dev)[None] > 0)
    children = torch.full((B, C * NUM_MOVES + 1), NO_CHILD, dtype=tree.children.dtype,
                          device=dev)
    flat = torch.where(is_child, parent_new * NUM_MOVES + action_rows.long(),
                       torch.full_like(parent_new, C * NUM_MOVES))
    children.scatter_(1, flat, torch.arange(C, device=dev, dtype=children.dtype
                                            ).expand(B, C).clone())
    children = children[:, :C * NUM_MOVES].reshape(B, C, NUM_MOVES)

    return Tree(
        n=rows(tree.n), w=rows(tree.w), w_outcome=rows(tree.w_outcome),
        score_sum=rows(tree.score_sum), v_var_sum=rows(tree.v_var_sum),
        vz_var_sum=rows(tree.vz_var_sum), v_m3_sum=rows(tree.v_m3_sum),
        init_util=rows(tree.init_util), init_outcome=rows(tree.init_outcome),
        init_score=rows(tree.init_score), init_err=rows(tree.init_err),
        log_priors=rows(tree.log_priors),
        children=children,
        edge_n=rows(tree.edge_n), edge_w=rows(tree.edge_w),
        edge_wz=rows(tree.edge_wz),
        color=rows(tree.color),
        is_terminal=rows(tree.is_terminal),
        evaluated=rows(tree.evaluated),
        next_free=num.clamp(1, C),
        v_categorical=rows(tree.v_categorical),
        parent=parent_new.to(torch.int32),
        parent_action=torch.where(compact_reach, action_rows,
                                  torch.zeros_like(action_rows)),
        s_stones=rows(tree.s_stones), s_chain=rows(tree.s_chain),
        s_last5=rows(tree.s_last5), s_ko=rows(tree.s_ko),
        s_cpass=rows(tree.s_cpass), s_hash=rows(tree.s_hash),
        s_legal=rows(tree.s_legal),
    )
