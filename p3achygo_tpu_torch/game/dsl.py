"""ASCII board DSL for tests (port of p3achygo_tpu/game/dsl.py; reference
cc/game/board_dsl.h:14-50).

'x'/'X' black, 'o'/'O' white, '.'/'+' empty; whitespace ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from p3achygo_tpu_torch.constants import BLACK, BOARD_LEN, DEFAULT_KOMI, EMPTY, WHITE
from p3achygo_tpu_torch.game.board import GoState, from_stones


def parse_dsl(dsl: str, board_len: int = BOARD_LEN) -> np.ndarray:
    """Parse DSL text into an int8 stones array of [board_len**2].

    Each non-blank line is one board row starting at column 0; unspecified
    rows/columns are empty.
    """
    rows = [line.strip() for line in dsl.splitlines() if line.strip()]
    stones = np.zeros((board_len * board_len,), np.int8)
    if len(rows) > board_len:
        raise ValueError(f"DSL has {len(rows)} rows; expected <= {board_len}")
    for i, row in enumerate(rows):
        chars = [ch for ch in row if not ch.isspace()]
        if len(chars) > board_len:
            raise ValueError(
                f"DSL row {i} has {len(chars)} cells; expected <= {board_len}")
        for j, ch in enumerate(chars):
            idx = i * board_len + j
            if ch in ("x", "X"):
                stones[idx] = BLACK
            elif ch in ("o", "O"):
                stones[idx] = WHITE
            elif ch in (".", "+"):
                stones[idx] = EMPTY
            else:
                raise ValueError(f"bad DSL char {ch!r}")
    return stones


def board_from_dsl(dsl: str, komi: float = DEFAULT_KOMI, to_move: int = BLACK,
                   device="cuda") -> GoState:
    """A batch of one GoState from DSL text. Partial grids leave the rest
    empty."""
    return from_stones(torch.from_numpy(parse_dsl(dsl))[None], komi=komi,
                       to_move=to_move, device=device)


def render(stones) -> str:
    """ASCII-render a [361] stones array (debugging)."""
    s = np.asarray(torch.as_tensor(stones).cpu()).reshape(BOARD_LEN, BOARD_LEN)
    sym = {EMPTY: ".", BLACK: "x", WHITE: "o"}
    return "\n".join(" ".join(sym[int(v)] for v in row) for row in s)
