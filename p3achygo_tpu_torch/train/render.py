"""Board-render training diagnostics (port of p3achygo_tpu/train/render.py;
reference train.py:748-1020 log_board_position).

Renders one sample position from a training batch with the model's
predictions against the ground-truth targets — ASCII board, top-5 policy
moves (pred vs target), outcome/score/q-head comparisons and an ownership
map — so a generation's training quality can be eyeballed from the run
log, matching the reference's every-5th-log-interval board dumps.
"""
from __future__ import annotations

import numpy as np
import torch

from p3achygo_tpu_torch.constants import BLACK, BOARD_LEN, NUM_LOCS, WHITE

_COLS = "ABCDEFGHJKLMNOPQRST"


def _coords(move_idx: int) -> str:
    if move_idx >= NUM_LOCS:
        return "PASS"
    i, j = divmod(int(move_idx), BOARD_LEN)
    return f"{_COLS[j]}{BOARD_LEN - i}"


def _board_lines(board: np.ndarray, marks=None) -> list:
    sym = {0: ".", BLACK: "x", WHITE: "o"}
    lines = []
    for i in range(BOARD_LEN):
        row = []
        for j in range(BOARD_LEN):
            ch = sym[int(board[i, j])]
            if marks is not None and (i, j) in marks:
                ch = marks[(i, j)]
            row.append(ch)
        lines.append(f"{BOARD_LEN - i:>2} " + " ".join(row))
    lines.append("   " + " ".join(_COLS[:BOARD_LEN]))
    return lines


def _np(x) -> np.ndarray:
    """A tensor (any device, any float type) or array -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def render_sample(planes, scalars, outputs, targets, idx: int = 0) -> str:
    """ASCII diagnostic for batch row `idx` (planes NHWC / scalars = model
    inputs, outputs = ModelOutputs, targets = a losses.GroundTruth)."""
    p = _np(planes[idx])
    s = _np(scalars[idx])
    to_play = BLACK if s[0] > 0.5 else WHITE
    komi = abs(float(s[-1])) * 15.0
    board = np.zeros((BOARD_LEN, BOARD_LEN), np.int8)
    own_c = to_play
    board[p[:, :, 0] > 0.5] = own_c
    board[p[:, :, 1] > 0.5] = -own_c

    softmax = lambda x: np.exp(x - x.max()) / np.exp(x - x.max()).sum()
    pi_pred = softmax(_np(outputs.pi_logits[idx]).astype(np.float32))
    pi_tgt = _np(targets.policy[idx])
    out_probs = _np(outputs.outcome_probs[idx]).astype(np.float32)
    score_probs = _np(outputs.score_probs[idx]).astype(np.float32)
    score_vals = np.arange(score_probs.shape[-1]) - score_probs.shape[-1] / 2 \
        + 0.5
    score_pred = float((score_probs * score_vals).sum())

    lines = ["=" * 64,
             f"TRAIN SAMPLE  to_play={'BLACK(x)' if to_play == BLACK else 'WHITE(o)'}  komi={komi:.1f}",
             "=" * 64]
    lines += _board_lines(board)
    top_p = np.argsort(-pi_pred)[:5]
    top_t = np.argsort(-pi_tgt)[:5]
    lines.append("policy pred : " + "  ".join(
        f"{_coords(m)}({pi_pred[m]:.3f})" for m in top_p))
    lines.append("policy tgt  : " + "  ".join(
        f"{_coords(m)}({pi_tgt[m]:.3f})" for m in top_t))
    go = _np(targets.game_outcome[idx])
    z = float(go[1] - go[0])
    lines.append(
        f"outcome pred (loss/win): {out_probs[0]:.3f}/{out_probs[1]:.3f}"
        f"   target z: {z:+.1f}")
    sm = float(_np(targets.score[idx]))
    lines.append(f"score pred: {score_pred:+.1f}   target: {sm:+.1f}")
    for hname, head, tgt_arr in (("q6", outputs.q6, targets.q6),
                                 ("q16", outputs.q16, targets.q16),
                                 ("q50", outputs.q50, targets.q50)):
        pred = float(_np(head[idx]))
        tgt = float(_np(tgt_arr[idx]))
        lines.append(f"{hname:>4} pred {pred:+.3f}  target {tgt:+.3f}")
    # ownership map: model's absolute-black view vs target
    own_pred = _np(outputs.ownership[idx]).astype(np.float32).reshape(
        BOARD_LEN, BOARD_LEN)
    if to_play != BLACK:
        own_pred = -own_pred
    own_rows = []
    for i in range(0, BOARD_LEN, 3):  # coarse 7-row summary
        own_rows.append(" ".join(
            "x" if v > 0.3 else ("o" if v < -0.3 else ".")
            for v in own_pred[i][::3]))
    lines.append("ownership pred (coarse, black=x): " + " / ".join(own_rows))
    return "\n".join(lines)
