"""Plain Go rules for the benchmark: a one-board engine in NumPy that
replays and judges the program's moves, and a batched random-game maker
for the start positions.

The rules are those the JAX package documents (cc/game/board.cc of
p3achygo): a stone joins the chains of its colour it touches; opponent
chains left without a liberty are captured; a move whose own chain then
has no liberty (self-capture) is illegal; a move that recreates an earlier
position of the game (positional superko: the stones alone, whoever is to
move) is illegal; a pass is always legal, and two passes in a row end the
game. The simple-ko point is where exactly one stone was just captured by a
new one-stone chain that has exactly one liberty. The cheap legality the
search uses leaves positional superko out (a documented deviation): it is
empty, not self-capture and not the simple-ko point.

Nothing here imports the program or JAX.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

BOARD = 19
POINTS = BOARD * BOARD  # 361
PASS = POINTS  # 361
NOOP = -1
BLACK, WHITE, EMPTY = 1, -1, 0
LAST_MOVES = 5


def _neighbours() -> List[Tuple[int, ...]]:
    out = []
    for p in range(POINTS):
        i, j = divmod(p, BOARD)
        nb = []
        if i > 0:
            nb.append(p - BOARD)
        if i < BOARD - 1:
            nb.append(p + BOARD)
        if j > 0:
            nb.append(p - 1)
        if j < BOARD - 1:
            nb.append(p + 1)
        out.append(tuple(nb))
    return out


NEIGHBOURS = _neighbours()


def chain_and_liberties(stones: np.ndarray, p: int) -> Tuple[set, set]:
    """(points of the chain at p, its empty neighbours) by flood fill."""
    colour = stones[p]
    chain, libs, todo = {p}, set(), [p]
    while todo:
        q = todo.pop()
        for r in NEIGHBOURS[q]:
            v = stones[r]
            if v == EMPTY:
                libs.add(r)
            elif v == colour and r not in chain:
                chain.add(r)
                todo.append(r)
    return chain, libs


def point_liberties(stones: np.ndarray) -> np.ndarray:
    """int32[361]: the liberties of each stone's chain, 0 on empty points."""
    out = np.zeros(POINTS, np.int32)
    seen = np.zeros(POINTS, bool)
    for p in range(POINTS):
        if stones[p] != EMPTY and not seen[p]:
            chain, libs = chain_and_liberties(stones, p)
            for q in chain:
                seen[q] = True
                out[q] = len(libs)
    return out


def resolve(stones: np.ndarray, p: int, colour: int):
    """Place `colour` at empty point p -> (stones after captures, points
    captured, liberties of the new stone's chain, its size)."""
    after = stones.copy()
    after[p] = colour
    captured = []
    for r in NEIGHBOURS[p]:
        if after[r] == -colour:
            chain, libs = chain_and_liberties(after, r)
            if not libs:
                captured.extend(chain)
                after[list(chain)] = EMPTY
    chain, libs = chain_and_liberties(after, p)
    return after, sorted(set(captured)), len(libs), len(chain)


class Game:
    """One board's game from a start position: the stones, who moves, the
    simple-ko point, passes in a row, moves played, the positions seen and
    the last five moves (oldest first; a pass is 361, no move -1)."""

    def __init__(self, stones: np.ndarray, to_move: int, max_len: int):
        self.stones = np.asarray(stones, np.int8).copy()
        self.to_move = int(to_move)
        self.ko = -1
        self.passes_in_row = 0
        self.move_count = 0
        self.max_len = max_len
        self.seen = {self.stones.tobytes()}
        self.last_moves = [NOOP] * LAST_MOVES

    def over(self) -> bool:
        return self.passes_in_row >= 2 or self.move_count >= self.max_len

    def cheap_illegal(self) -> np.ndarray:
        """bool[362]: occupied, self-capture or the simple-ko point (the
        search's cheap legality, superko aside)."""
        bad = np.zeros(PASS + 1, bool)
        bad[:POINTS] = self.stones != EMPTY
        libs = point_liberties(self.stones)
        c = self.to_move
        for p in range(POINTS):
            if bad[p]:
                continue
            ok = False
            for r in NEIGHBOURS[p]:
                v = self.stones[r]
                if v == EMPTY or (v == c and libs[r] >= 2) or (v == -c and libs[r] == 1):
                    ok = True
                    break
            bad[p] = not ok
        if self.ko >= 0:
            bad[self.ko] = True
        return bad

    def why_illegal(self, move: int) -> str:
        """'' if `move` is legal in full (superko included), else the cause."""
        if move == PASS:
            return ""
        if not 0 <= move < POINTS:
            return "off the board"
        if self.stones[move] != EMPTY:
            return "occupied"
        after, _, libs, _ = resolve(self.stones, move, self.to_move)
        if libs == 0:
            return "self-capture"
        if after.tobytes() in self.seen:
            return "positional superko"
        return ""

    def play(self, move: int) -> None:
        """Play a legal move (why_illegal(move) == '')."""
        if move == PASS:
            self.passes_in_row += 1
            self.ko = -1
            rec = PASS
        else:
            after, captured, libs, size = resolve(self.stones, move, self.to_move)
            self.ko = captured[0] if (len(captured) == 1 and size == 1 and libs == 1) else -1
            self.stones = after
            self.seen.add(after.tobytes())
            self.passes_in_row = 0
            rec = move
        self.last_moves = self.last_moves[1:] + [rec]
        self.to_move = -self.to_move
        self.move_count += 1


_NBR_IDX = np.array([list(n) + [POINTS] * (4 - len(n)) for n in NEIGHBOURS])
_STRUCTURE = np.zeros((3, 3, 3), bool)
_STRUCTURE[1] = [[0, 1, 0], [1, 1, 1], [0, 1, 0]]


def _chains(flat: np.ndarray):
    """Chains of B boards [B, 361] at once -> (labels int[B, 362], one
    label a chain over all boards and colours, 0 on empty points and on the
    off-board column 361; liberties int[B, 362] of each point's chain)."""
    from scipy import ndimage

    B = flat.shape[0]
    grid = flat.reshape(B, BOARD, BOARD)
    lab_b, nb = ndimage.label(grid == BLACK, _STRUCTURE)
    lab_w, _ = ndimage.label(grid == WHITE, _STRUCTURE)
    labels = np.where(lab_w > 0, lab_w + nb, lab_b).reshape(B, POINTS).astype(np.int32)
    padded = np.concatenate([labels, np.zeros((B, 1), labels.dtype)], axis=1)
    nl = padded[:, _NBR_IDX]  # [B, 361, 4] neighbour chain labels
    first = nl > 0
    for d in range(1, 4):
        for e in range(d):
            first[:, :, d] &= nl[:, :, d] != nl[:, :, e]
    count_at = first & (flat == EMPTY)[:, :, None]
    libs_of = np.bincount(nl[count_at], minlength=int(labels.max()) + 1)
    libs_of[0] = 0
    return padded, libs_of[padded]


def batch_point_liberties(stones: np.ndarray) -> np.ndarray:
    """int32[B, 361]: `point_liberties` of B boards at once."""
    flat = np.asarray(stones, np.int8)
    return _chains(flat)[1][:, :POINTS].astype(np.int32)


def random_games(lengths: np.ndarray, rng: np.random.Generator
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random legal games on len(lengths) boards at once, board b playing
    lengths[b] moves on points (no pass), each uniform over the points that
    are empty, not self-capture and not the simple-ko point. Positional
    superko beyond simple ko is not checked here: every position made is a
    legal board (no chain without a liberty). Returns (stones int8[B, 361],
    to_move int8[B], moves int32[B, max(lengths)], -1 after a board's
    last move)."""
    lengths = np.asarray(lengths, np.int64)
    B = lengths.shape[0]
    T = int(lengths.max()) if B else 0
    flat = np.zeros((B, POINTS), np.int8)
    to_move = np.full(B, BLACK, np.int8)
    ko = np.full(B, -1, np.int64)
    moves = np.full((B, T), -1, np.int32)
    for t in range(T):
        # Only the boards still playing do work in this ply.
        r = np.nonzero(lengths > t)[0]
        sub, tm, kb = flat[r], to_move[r], ko[r]
        rows = np.arange(r.shape[0])
        edge = np.full((r.shape[0], 1), 9, np.int8)
        padded, libs_pt = _chains(sub)
        nbr_col = np.concatenate([sub, edge], axis=1)[:, _NBR_IDX]  # [b, 361, 4]
        nbr_libs = libs_pt[:, _NBR_IDX]
        c = tm[:, None, None]
        ok = ((nbr_col == EMPTY)
              | ((nbr_col == c) & (nbr_libs >= 2))
              | ((nbr_col == -c) & (nbr_libs == 1))).any(axis=2)
        legal = (sub == EMPTY) & ok
        legal[rows, np.clip(kb, 0, POINTS - 1)] &= kb < 0
        score = np.where(legal, rng.random(legal.shape, np.float32), -1.0)
        pick = score.argmax(axis=1)
        playing = legal.any(axis=1)
        moves[r[playing], t] = pick[playing]
        # Place; capture the opponent chains whose last liberty this was.
        mv_nbr = _NBR_IDX[pick]  # [b, 4]
        mv_lab = padded[rows[:, None], mv_nbr]
        mv_col = nbr_col[rows, pick]  # [b, 4]
        cap_lab = np.where((mv_col == -tm[:, None]) & (libs_pt[rows[:, None], mv_nbr] == 1)
                           & (mv_lab > 0), mv_lab, -1)
        captured = ((padded[:, :POINTS, None] == cap_lab[:, None, :]).any(axis=2)
                    & playing[:, None])
        n_cap = captured.sum(axis=1)
        sub = sub.copy()
        sub[captured] = EMPTY
        sub[rows[playing], pick[playing]] = tm[playing]
        # Simple ko: one stone captured by a lone new stone with one liberty.
        friend = (mv_col == tm[:, None]).any(axis=1)
        own_libs = (np.concatenate([sub, edge], axis=1)[rows[:, None], mv_nbr] == EMPTY).sum(axis=1)
        cap_pt = captured.argmax(axis=1)
        ko[r] = np.where(playing, np.where((n_cap == 1) & ~friend & (own_libs == 1), cap_pt, -1), kb)
        flat[r] = sub
        to_move[r] = np.where(playing, -tm, tm)
    return flat, to_move, moves
