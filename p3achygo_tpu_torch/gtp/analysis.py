"""Analysis snapshots (port of p3achygo_tpu/gtp/analysis.py; reference
cc/analysis/analysis.{h,cc}:11-33).

Builds lz-analyze-style info rows from a search result: per candidate move
its visits, winrate (Q mapped from [-1, 1] to [0, 10000]), prior (per
10000), order and a principal variation walked on the host through the
(carried) tree's child table by max edge visits.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from p3achygo_tpu_torch.gtp.service import action_to_gtp_vertex


def _np(t, board_idx: int) -> np.ndarray:
    return t[board_idx].detach().cpu().numpy()


def extract_pv(tree, first_move: int, board_idx: int = 0,
               max_len: int = 10) -> List[int]:
    """Follow max-visit children from root's `first_move` edge."""
    ch = _np(tree.children, board_idx)
    en = _np(tree.edge_n, board_idx)
    pv = [int(first_move)]
    node = int(ch[0, int(first_move)])
    while 0 <= node < ch.shape[0] and len(pv) < max_len:
        row = en[node]
        if row.max() <= 0:
            break
        a = int(row.argmax())
        pv.append(a)
        node = int(ch[node, a])
    return pv


def analysis_rows(result, board_idx: int = 0, max_moves: int = 10,
                  work: Optional[object] = None) -> List[dict]:
    visits = _np(result.root_child_visits, board_idx)
    q = _np(result.root_child_q, board_idx)
    prior = _np(result.root_priors, board_idx)
    order = np.argsort(-visits, kind="stable")
    rows = []
    for rank, mv in enumerate(order[:max_moves]):
        if visits[mv] == 0 and rank > 0:
            break
        winrate = (float(q[mv]) + 1.0) / 2.0
        if work is not None:
            pv = " ".join(action_to_gtp_vertex(a)
                          for a in extract_pv(work, int(mv), board_idx))
        else:
            pv = action_to_gtp_vertex(int(mv))
        rows.append(dict(
            move=action_to_gtp_vertex(int(mv)),
            visits=int(visits[mv]),
            winrate=int(round(max(min(winrate, 1.0), 0.0) * 10000)),
            prior=int(round(float(prior[mv]) * 10000)),
            order=rank,
            pv=pv,
        ))
    return rows


def format_lz_analyze(rows: List[dict]) -> str:
    """One lz-analyze info line."""
    parts = []
    for r in rows:
        parts.append(
            f"info move {r['move']} visits {r['visits']} "
            f"winrate {r['winrate']} prior {r['prior']} order {r['order']} "
            f"pv {r['pv']}")
    return " ".join(parts)
