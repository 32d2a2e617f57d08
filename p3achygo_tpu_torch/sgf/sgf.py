"""SGF parse + serialize (port of p3achygo_tpu/sgf/sgf.py, a copy; it
replaces cc/sgf/, 763 LoC C++, and the sgfmill-based SL pipeline reader).

Recursive-descent parser over SGF's `(;A[v];B[v](...)...)` grammar
(parse_sgf.h:14-32); keeps the full variation tree but exposes the main
line for game replay. Serializer mirrors sgf_recorder.cc output:
root properties GM/FF/SZ/KM/PB/PW/RE + one node per move.
"""
from __future__ import annotations

import dataclasses
import string
from typing import Dict, Iterator, List, Optional, Tuple

from p3achygo_tpu_torch.constants import BLACK, BOARD_LEN, PASS_MOVE, WHITE

_COORDS = string.ascii_lowercase  # a-s for 19x19


@dataclasses.dataclass
class SgfNode:
    props: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    children: List["SgfNode"] = dataclasses.field(default_factory=list)

    def get(self, key: str) -> Optional[str]:
        vals = self.props.get(key)
        return vals[0] if vals else None


def loc_to_sgf(action: int) -> str:
    """Move encoding (0..360, 361=pass) -> SGF coords ('' for pass)."""
    if action < 0 or action >= PASS_MOVE:
        return ""
    i, j = divmod(action, BOARD_LEN)
    return _COORDS[j] + _COORDS[i]


def sgf_to_loc(s: str) -> int:
    """SGF coords -> move encoding. '' or 'tt' = pass."""
    if s == "" or s == "tt":
        return PASS_MOVE
    j = _COORDS.index(s[0])
    i = _COORDS.index(s[1])
    return i * BOARD_LEN + j


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def _peek(self) -> str:
        self._skip_ws()
        if self.pos >= len(self.text):
            raise ValueError("unexpected end of SGF")
        return self.text[self.pos]

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.pos}, "
                             f"got {self.text[self.pos]!r}")
        self.pos += 1

    def parse(self) -> SgfNode:
        self._expect("(")
        root = self._parse_sequence()
        return root

    def _parse_sequence(self) -> SgfNode:
        """Parse `;node;node(...)(...)` until the matching ')'. Returns the
        first node; successive nodes chain via children[0]."""
        first = None
        cur = None
        while True:
            ch = self._peek()
            if ch == ";":
                self.pos += 1
                node = self._parse_node()
                if first is None:
                    first = node
                else:
                    cur.children.append(node)
                cur = node
            elif ch == "(":
                self.pos += 1
                child = self._parse_sequence()
                (cur if cur is not None else first).children.append(child)
            elif ch == ")":
                self.pos += 1
                if first is None:
                    raise ValueError("empty SGF variation")
                return first
            else:
                raise ValueError(f"unexpected {ch!r} at {self.pos}")

    def _parse_node(self) -> SgfNode:
        node = SgfNode()
        while True:
            self._skip_ws()
            if self.pos >= len(self.text) or not self.text[self.pos].isalpha():
                return node
            start = self.pos
            while self.text[self.pos].isalpha():
                self.pos += 1
            key = self.text[start:self.pos]
            vals = []
            while self._peek() == "[":
                self.pos += 1
                buf = []
                while True:
                    c = self.text[self.pos]
                    if c == "\\":
                        buf.append(self.text[self.pos + 1])
                        self.pos += 2
                    elif c == "]":
                        self.pos += 1
                        break
                    else:
                        buf.append(c)
                        self.pos += 1
                vals.append("".join(buf))
            node.props.setdefault(key, []).extend(vals)


def parse_sgf(text: str) -> SgfNode:
    """Parse SGF text -> root node (variation tree preserved)."""
    return _Parser(text).parse()


def main_line(root: SgfNode) -> Iterator[SgfNode]:
    node = root
    while node is not None:
        yield node
        node = node.children[0] if node.children else None


def extract_moves(root: SgfNode) -> List[Tuple[int, int]]:
    """-> [(color, action)] along the main line (ExtractGameInfo parity)."""
    moves = []
    for node in main_line(root):
        if "B" in node.props:
            moves.append((BLACK, sgf_to_loc(node.props["B"][0])))
        elif "W" in node.props:
            moves.append((WHITE, sgf_to_loc(node.props["W"][0])))
    return moves


def game_info(root: SgfNode) -> Dict[str, object]:
    return {
        "board_size": int(root.get("SZ") or BOARD_LEN),
        "komi": float(root.get("KM") or 7.5),
        "result": root.get("RE") or "",
        "pb": root.get("PB") or "",
        "pw": root.get("PW") or "",
        "handicap": int(root.get("HA") or 0),
    }


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("]", "\\]")


def serialize_game(moves: List[Tuple[int, int]], komi: float = 7.5,
                   result: str = "", pb: str = "p3achygo_tpu",
                   pw: str = "p3achygo_tpu",
                   board_len: int = BOARD_LEN) -> str:
    """[(color, action)] -> SGF text (SgfRecorder parity)."""
    parts = [f"(;GM[1]FF[4]SZ[{board_len}]KM[{komi}]"
             f"PB[{_escape(pb)}]PW[{_escape(pw)}]"]
    if result:
        parts.append(f"RE[{_escape(result)}]")
    for color, action in moves:
        tag = "B" if color == BLACK else "W"
        parts.append(f";{tag}[{loc_to_sgf(action)}]")
    parts.append(")")
    return "".join(parts)


def serialize_game_with_tree(moves: List[Tuple[int, int]], tree,
                             komi: float = 7.5, result: str = "",
                             pb: str = "p3achygo_tpu",
                             pw: str = "p3achygo_tpu",
                             board_len: int = BOARD_LEN) -> str:
    """SGF with the final position's search tree as variations
    (RecordSingleSgfWithTrees, sgf_recorder.cc:232-257; PopulateTree
    sgf_recorder.cc:117-148).

    `tree` is a search Tree of the port (batch of 1): visited children (edge n > 0)
    become variations sorted by ascending visit count like the reference,
    and every tree node carries a C[] comment with
    color/N/Q/Q_z/nn_outcome_est/nn_score_est. Deviation: the reference's
    selfplay per-move root logging is compiled out (#if 0, "broken for
    MCGS"); only this GTP-exposed current-tree form exists, which is what
    we mirror.
    """
    import numpy as np

    def first(t):
        t = t[0].detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    n = first(tree.n)
    w = first(tree.w)
    wz = first(tree.w_outcome)
    init_outcome = first(tree.init_outcome)
    init_score = first(tree.init_score)
    children = first(tree.children)
    edge_n = first(tree.edge_n)
    color = first(tree.color)

    def comment(node: int) -> str:
        nn = max(int(n[node]), 1)
        c = "B" if int(color[node]) == BLACK else "W"
        return (f"Root Color: {c}, N: {int(n[node])}, "
                f"Q: {w[node] / nn:f}, Q_z: {wz[node] / nn:f}, "
                f"nn_outcome_est: {init_outcome[node]:f}, "
                f"nn_score_est: {init_score[node]:f}")

    def emit(node: int, depth: int = 0) -> str:
        """Variations under `node`: visited children ascending by visits."""
        if depth > 48:  # kMaxCallDepth guard (sgf_recorder.cc:30)
            return ""
        kids = [(int(edge_n[node, a]), a, int(children[node, a]))
                for a in np.nonzero((edge_n[node] > 0)
                                    & (children[node] >= 0))[0]]
        kids.sort()
        tag = "B" if int(color[node]) == BLACK else "W"
        out = []
        for _, a, ch in kids:
            body = (f";{tag}[{loc_to_sgf(int(a))}]"
                    f"C[{_escape(comment(ch))}]" + emit(ch, depth + 1))
            out.append(body if len(kids) == 1 else f"({body})")
        return "".join(out)

    parts = [f"(;GM[1]FF[4]SZ[{board_len}]KM[{komi}]"
             f"PB[{_escape(pb)}]PW[{_escape(pw)}]"]
    if result:
        parts.append(f"RE[{_escape(result)}]")
    for mcolor, action in moves:
        tag = "B" if mcolor == BLACK else "W"
        parts.append(f";{tag}[{loc_to_sgf(action)}]")
    parts.append(f";C[{_escape(comment(0))}]")
    parts.append(emit(0))
    parts.append(")")
    return "".join(parts)


def result_string(black_score: float, white_score: float,
                  by_resign: bool = False, winner: int = 0) -> str:
    if by_resign:
        return "B+R" if winner == BLACK else "W+R"
    margin = abs(black_score - white_score)
    return f"B+{margin:g}" if black_score > white_score else f"W+{margin:g}"
