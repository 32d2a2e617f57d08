"""Opening book (port of p3achygo_tpu/selfplay/book.py, a copy; mirrors
cc/selfplay/book.h:9-16 kOpeningBook).

Six fixed opening lines of up to 4 moves, played from the empty board
with alternating colors starting BLACK. A fresh game starts from a
uniformly-chosen random PREFIX of a uniformly-chosen line with
probability `play_from_book_prob` (GetInitState,
self_play_thread.cc:216-232). The reference ships this dead —
kPlayFromBookProb = 0.0 (self_play_thread.cc:50) — and so does this
repo's RunConfig default; the mechanism is carried for parity and is
unit-tested at prob=1 (tests/test_book.py,
tests/test_torch_reuse.py).

Locs are (row, col) flattened row-major to match game/board.py actions.
"""
from __future__ import annotations

from typing import List, Tuple

from p3achygo_tpu_torch.constants import BOARD_LEN

# cc/selfplay/book.h:9-16, verbatim (row, col) pairs.
OPENING_BOOK: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((3, 3), (15, 15), (15, 4), (4, 15)),
    ((3, 3), (15, 15), (16, 4), (4, 15)),
    ((3, 3), (15, 4), (15, 16), (15, 4)),
    ((3, 3), (15, 4), (15, 15), (4, 15)),
    ((3, 3), (15, 15), (2, 15), (15, 15)),
    ((3, 3), (15, 15), (2, 15), (16, 15)),
)


def sample_book_prefix(rng) -> List[int]:
    """Random prefix of a random book line as flat actions (may repeat a
    loc across lines — the reference plays lines verbatim and PlayMove on
    an occupied point is the caller's concern; line 3 repeats (15,4) and
    line 5 repeats (15,15), which the reference's Board::PlayMove treats
    as a no-op illegal move — we truncate the prefix at the first repeat
    instead, keeping the position legal)."""
    line = OPENING_BOOK[int(rng.uniform() * len(OPENING_BOOK)) %
                        len(OPENING_BOOK)]
    num = int(round(rng.uniform() * len(line)))
    seen = set()
    prefix = []
    for r, c in line[:num]:
        loc = r * BOARD_LEN + c
        if loc in seen:
            break
        seen.add(loc)
        prefix.append(loc)
    return prefix
