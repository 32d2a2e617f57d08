"""GTP engine service (port of p3achygo_tpu/gtp/service.py; reference
cc/gtp/, service.h:20-65).

A plain synchronous loop: a genmove is one search call. Pondering searches
the carried root tree in idle slices between commands (select on stdin),
and lz-analyze with an interval streams info lines between search batches
the same way. The service keeps one reuse tree across commands: genmove and
play advance it under the played move (Reap), ponder and analyze batches
accumulate into it (root-compacted back to a fixed capacity).

The board is a batch of one: every state field is a [1] tensor on the
service's device, and the search runs on it directly. Random draws come
from a `torch.Generator` seeded at 0; with the GTP defaults (noise_scale 0,
tau 0) the chosen move does not depend on them.
"""
from __future__ import annotations

import dataclasses
import io
import select
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch

from p3achygo_tpu_torch.constants import BLACK, BOARD_LEN, PASS_MOVE, WHITE
from p3achygo_tpu_torch.game.board import (
    GoState,
    dry_run_status,
    is_game_over,
    new_state,
    step,
)
from p3achygo_tpu_torch.game.dsl import render
from p3achygo_tpu_torch.game.scoring import score as score_board
from p3achygo_tpu_torch.gtp.time_control import TimeControl
from p3achygo_tpu_torch.mcts.bias import make_bias_table
from p3achygo_tpu_torch.mcts.gumbel import EvalFn, SearchParams, search_root
from p3achygo_tpu_torch.mcts.tree import compact_root, compact_subtree, make_tree
from p3achygo_tpu_torch.sgf import extract_moves, parse_sgf, serialize_game_with_tree

_COLS = "ABCDEFGHJKLMNOPQRST"  # GTP skips I


def gtp_vertex_to_action(vertex: str) -> int:
    v = vertex.strip().upper()
    if v == "PASS":
        return PASS_MOVE
    col = _COLS.index(v[0])
    row = int(v[1:])  # 1 = bottom row
    i = BOARD_LEN - row
    return i * BOARD_LEN + col


def action_to_gtp_vertex(action: int) -> str:
    if action < 0 or action >= PASS_MOVE:
        return "pass"
    i, j = divmod(int(action), BOARD_LEN)
    return f"{_COLS[j]}{BOARD_LEN - i}"


def parse_color(s: str) -> int:
    s = s.strip().lower()
    if s in ("b", "black"):
        return BLACK
    if s in ("w", "white"):
        return WHITE
    raise ValueError(f"bad color {s!r}")


@dataclasses.dataclass
class GtpConfig:
    search: SearchParams = dataclasses.field(
        default_factory=lambda: SearchParams(n=128, k=8, noise_scale=0.0,
                                             tau=0.0))
    name: str = "p3achygo_tpu"
    version: str = "0.1"
    # Carried-tree capacity across commands (0 = 2*n+2); ponder batches
    # accumulate into it up to ponder_visit_cap root visits
    # (total_visit_budget 1<<17, service.cc:692).
    reuse_capacity: int = 0
    ponder: bool = False
    ponder_visit_cap: int = 1 << 14
    # Value-bias cache (use_bias_cache, eval.cc:156-163; 0 = off).
    bias_lambda: float = 0.0
    bias_alpha: float = 0.8


class GtpService:
    """Stateful GTP engine over a single board (a batch of one)."""

    COMMANDS = [
        "protocol_version", "name", "version", "known_command",
        "list_commands", "quit", "boardsize", "clear_board", "komi", "play",
        "genmove", "showboard", "final_score", "undo", "loadsgf",
        "p3achygo-ownership", "time_settings", "time_left", "lz-analyze",
        "p3achygo-serialize_sgf_with_trees",
    ]

    def __init__(self, eval_fn: EvalFn, config: Optional[GtpConfig] = None,
                 device="cuda"):
        self.eval_fn = eval_fn
        self.config = config or GtpConfig()
        self.device = torch.device(device)
        self.komi = 7.5
        self._history: List[GoState] = []
        self._moves: List[Tuple[int, int]] = []  # (color, action) played
        self.state = self._fresh()
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.time_control = TimeControl()
        self._last_root_v = None
        self._cap = self.config.reuse_capacity \
            or (2 * self.config.search.n + 2)
        self._tree = make_tree(1, self._cap, self.device)
        self._bias = (make_bias_table(1, 1024, self.device)
                      if self.config.bias_lambda > 0 else None)

    def _action(self, action: int) -> torch.Tensor:
        return torch.tensor([action], dtype=torch.int64, device=self.device)

    def _as_mover(self, st: GoState, color: int) -> GoState:
        """`st` with `color` to move (GTP allows out-of-turn moves)."""
        if int(st.to_move[0]) == color:
            return st
        return st._replace(to_move=torch.full((1,), color, dtype=torch.int8,
                                              device=self.device))

    def _run_search(self, n: int, st: GoState):
        """Search of n visits with the carried tree (and the bias table when
        enabled) -> (result, working tree)."""
        params = dataclasses.replace(self.config.search, n=n,
                                     bias_lambda=self.config.bias_lambda,
                                     bias_alpha=self.config.bias_alpha)
        out = search_root(st, self.eval_fn, params, generator=self.generator,
                          init_tree=self._tree, reuse_capacity=self._cap,
                          bias_table=self._bias)
        if self._bias is not None:
            res, work, self._bias = out
        else:
            res, work = out
        return res, work

    def _fresh(self) -> GoState:
        return new_state(1, self.komi, device=self.device)

    def _reset_tree(self):
        self._tree = make_tree(1, self._cap, self.device)

    def _advance_tree(self, action: int, work=None):
        """Reap the carried tree under a played move (service.cc genmove /
        play paths advance current_root())."""
        src = work if work is not None else self._tree
        self._tree = compact_subtree(src, self._action(action), self._cap)

    def _play(self, st: GoState, color: int, action: int) -> None:
        """Record and play `action` for `color` from `st` (the current
        state, possibly with its mover flipped)."""
        self._history.append(self.state)
        self._moves.append((color, action))
        self.state, _ = step(st, self._action(action))

    def ponder_once(self) -> int:
        """One search batch on the current root, accumulated into the
        carried tree (Ponder, service.cc:677-705). Returns the root's
        total visits so the caller can stop at ponder_visit_cap."""
        if bool(is_game_over(self.state)[0]):
            return 1 << 30
        _, work = self._run_search(self.config.search.n, self.state)
        self._tree = compact_root(work, self._cap)
        return int(self._tree.n[0, 0])

    # ---------------- command dispatch ----------------
    def handle(self, line: str) -> Tuple[bool, str]:
        """-> (ok, response). Raises SystemExit on quit."""
        parts = line.strip().split()
        if not parts:
            return True, ""
        if parts[0].isdigit():  # optional numeric id
            parts = parts[1:]
        if not parts:
            return True, ""
        cmd, args = parts[0], parts[1:]
        fn = getattr(self, f"cmd_{cmd.replace('-', '_')}", None)
        if cmd == "p3achygo-ownership":
            fn = self.cmd_ownership
        if fn is None:
            return False, "unknown command"
        try:
            return True, fn(*args)
        except SystemExit:
            raise
        except Exception as e:  # GTP failure response
            return False, str(e)

    # ---------------- commands ----------------
    def cmd_protocol_version(self):
        return "2"

    def cmd_name(self):
        return self.config.name

    def cmd_version(self):
        return self.config.version

    def cmd_known_command(self, cmd=""):
        return "true" if cmd in self.COMMANDS else "false"

    def cmd_list_commands(self):
        return "\n".join(self.COMMANDS)

    def cmd_quit(self):
        raise SystemExit

    def cmd_boardsize(self, size=""):
        if int(size) != BOARD_LEN:
            raise ValueError(f"unacceptable size (compiled for {BOARD_LEN})")
        return ""

    def cmd_clear_board(self):
        self._history = []
        self._moves = []
        self.state = self._fresh()
        self._reset_tree()
        return ""

    def cmd_komi(self, value=""):
        self.komi = float(value)
        self.state = self.state._replace(komi=torch.full(
            (1,), self.komi, dtype=torch.float32, device=self.device))
        self._reset_tree()  # carried values were computed for the old komi
        return ""

    def cmd_play(self, color="", vertex=""):
        c = parse_color(color)
        action = gtp_vertex_to_action(vertex)
        st = self._as_mover(self.state, c)
        if int(dry_run_status(st, self._action(action))[0]) != 0:
            raise ValueError("illegal move")
        self._play(st, c, action)
        self._advance_tree(action)
        return ""

    def cmd_undo(self):
        if not self._history:
            raise ValueError("cannot undo")
        self.state = self._history.pop()
        if self._moves:
            self._moves.pop()
        self._reset_tree()
        return ""

    def cmd_genmove(self, color=""):
        c = parse_color(color)
        st = self._as_mover(self.state, c)
        budget = self.time_control.compute_move_time_ms(
            int(st.move_count[0]), self._last_root_v)
        res, work = self._timed_search(st, budget)
        action = int(res.mcts_move[0])
        self._last_root_v = float(res.root_value[0])
        self._play(st, c, action)
        self._advance_tree(action, work)
        return action_to_gtp_vertex(action)

    def _timed_search(self, st, budget_ms, clock=None):
        """Search within a wall-clock budget by accumulated slices.

        The reference aborts a running search from a timer thread at the
        per-move budget (search.cc:795-807, time_control.cc:35). Here the
        search runs in slices of a few fixed visit counts that accumulate
        into the carried tree (the lz-analyze machinery, service.cc:677-705
        Ponder-style), and no new slice starts once the remaining budget
        would be overrun (predicted by the online ms/visit estimate). A
        byoyomi period is therefore never exceeded as long as one slice
        fits; the first slice always runs.

        budget_ms <= 0 = untimed: one fixed-visit search at config n.
        `clock` (for tests) -> current time in seconds.
        """
        clock = clock or time.time

        nmax = self.config.search.n
        if budget_ms <= 0:
            t0 = clock()
            res, work = self._run_search(nmax, st)
            self.time_control.observe_search((clock() - t0) * 1000.0,
                                             int(res.visits[0]))
            return res, work

        choices = tuple(n for n in (16, 32, 64, 128, 256, 512)
                        if n <= nmax) or (nmax,)
        t_start = clock()
        res = work = None
        # Hard cap so a mis-estimated ms/visit cannot loop unboundedly.
        max_slices = max(1, (8 * nmax) // max(choices[0], 1))
        for _ in range(max_slices):
            # Size each slice to the remaining budget: a generous byoyomi
            # period runs one deep (near-nmax) sequential-halving search;
            # a nearly spent budget drops to the smallest slice.
            remaining = budget_ms - (clock() - t_start) * 1000.0
            slice_n = self.time_control.pick_visits(
                max(int(remaining), 1), choices=choices, default=choices[0])
            t0 = clock()
            res, work = self._run_search(slice_n, st)
            self.time_control.observe_search((clock() - t0) * 1000.0,
                                             int(res.visits[0]))
            elapsed_ms = (clock() - t_start) * 1000.0
            est_next = self.time_control.ms_per_visit * choices[0]
            if elapsed_ms + est_next > budget_ms:
                break
            # Accumulate this slice into the carried tree so the next
            # slice (and the final result) builds on all visits so far.
            self._tree = compact_root(work, self._cap)
        return res, work

    def cmd_time_settings(self, main_s="0", byo_s="0", byo_stones="0"):
        self.time_control.set_time_settings(int(main_s), int(byo_s),
                                            int(byo_stones))
        return ""

    def cmd_time_left(self, color="", seconds="0", stones="0"):
        secs, stones = int(seconds), int(stones)
        if stones > 0:
            self.time_control.set_time_left(0, secs, stones)
        else:
            self.time_control.set_time_left(secs, 0, 0)
        return ""

    @staticmethod
    def _parse_analyze_args(args):
        """lz-analyze [color] [interval_centiseconds]."""
        interval_cs = None
        for a in args:
            if a.isdigit():
                interval_cs = int(a)
        return interval_cs

    def _analyze_batch(self):
        """One accumulated search batch -> (rows, formatted info line)."""
        from p3achygo_tpu_torch.gtp.analysis import analysis_rows, format_lz_analyze

        res, work = self._run_search(self.config.search.n, self.state)
        self._tree = compact_root(work, self._cap)
        rows = analysis_rows(res, work=self._tree)
        return rows, format_lz_analyze(rows)

    def cmd_lz_analyze(self, *args):
        """One-shot analysis snapshot (streaming happens in
        run_stdin_loop's analyze path, service.cc:561-605)."""
        _, line = self._analyze_batch()
        return line

    def analyze_stream(self, args, write: Callable[[str], None],
                       input_ready: Callable[[], bool],
                       max_batches: int = 1 << 20):
        """Stream lz-analyze info lines between search batches until a new
        command is pending on stdin (the reference's analyze thread,
        service.cc:561-605); the carried tree accumulates visits."""
        for _ in range(max_batches):
            _, line = self._analyze_batch()
            write(line + "\n")
            if input_ready():
                return

    def cmd_showboard(self):
        return "\n" + render(self.state.stones[0])

    def cmd_final_score(self):
        b, w, _ = score_board(self.state)
        b, w = float(b[0]), float(w[0])
        if b > w:
            return f"B+{b - w:g}"
        return f"W+{w - b:g}"

    def cmd_ownership(self):
        _, _, own = score_board(self.state)
        o = own[0].reshape(BOARD_LEN, BOARD_LEN).tolist()
        return "\n".join(" ".join(str(int(v)) for v in row) for row in o)

    def cmd_loadsgf(self, path="", move_num=""):
        with open(path) as f:
            root = parse_sgf(f.read())
        moves = extract_moves(root)
        if move_num:
            moves = moves[: int(move_num)]
        self.cmd_clear_board()
        for color, action in moves:
            self._play(self._as_mover(self.state, color), color, action)
        return ""

    def cmd_p3achygo_serialize_sgf_with_trees(self, path=""):
        """Write the game + the current carried search tree as SGF
        variations with per-node stat comments
        (GtpSerializeSgfWithTrees, service.cc:496-505; PopulateTree,
        sgf_recorder.cc:117-148). Ponder/analyze first to grow the tree."""
        if not path:
            raise ValueError("filename required")
        text = serialize_game_with_tree(self._moves, self._tree,
                                        komi=self.komi,
                                        pb=self.config.name,
                                        pw=self.config.name)
        with open(path, "w") as f:
            f.write(text)
        return path


def run_stdin_loop(service: GtpService, infile=None, outfile=None):
    """Blocking GTP REPL (client.cc parity) with idle-slice pondering and
    streamed lz-analyze when the input supports select()."""
    infile = infile or sys.stdin
    outfile = outfile or sys.stdout

    try:
        fd = infile.fileno()

        def input_ready() -> bool:
            return bool(select.select([fd], [], [], 0.0)[0])
    except (AttributeError, OSError, io.UnsupportedOperation):
        fd = None  # StringIO and other inputs without a descriptor: no idle work

        def input_ready() -> bool:
            return True

    def read_line():
        """Next stdin line; ponder in idle slices while waiting
        (Ponder, service.cc:667-705)."""
        if fd is None or not service.config.ponder:
            return infile.readline()
        while True:
            if input_ready():
                return infile.readline()
            if service.ponder_once() >= service.config.ponder_visit_cap:
                return infile.readline()  # cap reached: block normally

    while True:
        line = read_line()
        if line == "":
            return
        line = line.split("#")[0]
        if not line.strip():
            continue
        parts = line.strip().split()
        cmd = parts[1] if parts and parts[0].isdigit() and len(parts) > 1 \
            else (parts[0] if parts else "")
        if cmd == "lz-analyze" and fd is not None:
            interval = GtpService._parse_analyze_args(parts[1:])
            if interval is not None:
                outfile.write("=\n")
                outfile.flush()
                service.analyze_stream(
                    parts[1:], lambda s: (outfile.write(s),
                                          outfile.flush()), input_ready)
                outfile.write("\n")
                outfile.flush()
                continue
        try:
            ok, resp = service.handle(line)
        except SystemExit:
            outfile.write("=\n\n")
            outfile.flush()
            return
        prefix = "=" if ok else "?"
        outfile.write(f"{prefix} {resp}\n\n" if resp else f"{prefix}\n\n")
        outfile.flush()
