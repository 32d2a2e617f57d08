"""play_games experiment harness (port of p3achygo_tpu/experiments/
play_games.py; reference cc/experiments/play_games.cc, callbacks.h,
bias_callback.cc).

Plays full games with per-move callbacks. The reference loops games
sequentially on one NN thread; here `num_games` games run as ONE lockstep
batch: each move searches every live board together (Gumbel sequential
halving or PUCT by LCB, main.cc:12 --seq_halving) with tree reuse across
moves (root = root->children[move] + Reap, play_games.cc:46-51 ->
compact_subtree).

Callbacks receive host-side numpy views per move:

- PrintCallback renders the position each move (callbacks.h:18-29).
- BiasCallback keeps the top-|NN eval - MCTS eval| positions per game and
  per episode in bounded heaps and dumps them at game/episode end
  (bias_callback.cc), surfacing where the net disagrees most with search.
"""
from __future__ import annotations

import heapq
import sys
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from p3achygo_tpu_torch.constants import BLACK, NUM_MOVES, WHITE
from p3achygo_tpu_torch.game.board import is_game_over, new_state, step
from p3achygo_tpu_torch.game.dsl import render
from p3achygo_tpu_torch.game.scoring import score as score_boards
from p3achygo_tpu_torch.mcts.gumbel import EvalFn, SearchParams, gumbel, search_root
from p3achygo_tpu_torch.mcts.puct import PuctParams, search_root_puct
from p3achygo_tpu_torch.mcts.tree import compact_subtree, make_tree


@dataclass
class MoveInfo:
    """Per-board per-move snapshot handed to callbacks (the reference's
    (game, color, root, search_result) tuple, callbacks.h:11-13)."""
    game_idx: int
    move_num: int
    color_to_move: int
    position: np.ndarray  # int8[361] before the move
    last_five_moves: np.ndarray  # int32[5]
    move: int
    nn_eval: float  # root init_util_est
    mcts_eval: float  # root v (w/n)
    nn_v: float  # root init_outcome_est
    mcts_v: float  # root v_outcome
    nn_score: float  # root init_score_est
    mcts_score: float  # root score mean
    num_visits: int


@dataclass
class GameResult:
    game_idx: int
    winner: int  # BLACK/WHITE
    bscore: float
    wscore: float
    num_moves: int

    def __str__(self) -> str:
        w = "B" if self.winner == BLACK else "W"
        margin = (self.bscore - self.wscore if self.winner == BLACK
                  else self.wscore - self.bscore)
        return f"{w}+{margin:g}"


class Callback:
    def on_move(self, info: MoveInfo) -> None:  # pragma: no cover
        pass

    def on_game_end(self, result: GameResult) -> None:  # pragma: no cover
        pass

    def on_episode_end(self) -> None:  # pragma: no cover
        pass


class PrintCallback(Callback):
    """Prints move number + position per move (callbacks.h:18-29)."""

    def __init__(self, out=None):
        self.out = out or sys.stderr

    def on_move(self, info: MoveInfo) -> None:
        print(f"Game {info.game_idx} Move Num: {info.move_num}, Position:",
              file=self.out)
        print(render(info.position) + "\n", file=self.out)


@dataclass(order=True)
class _HeapItem:
    bias: float
    seq: int
    info: MoveInfo = field(compare=False)


class _BoundedMinHeap:
    """Keeps the `cap` largest-bias entries (core::Heap used as a bounded
    min-heap in bias_callback.cc:37-39)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._h: List[_HeapItem] = []
        self._seq = 0

    def push(self, bias: float, info: MoveInfo):
        item = _HeapItem(bias, self._seq, info)
        self._seq += 1
        if len(self._h) < self.cap:
            heapq.heappush(self._h, item)
        elif bias > self._h[0].bias:
            heapq.heapreplace(self._h, item)

    def drain_desc(self) -> List[_HeapItem]:
        out = sorted(self._h, key=lambda it: -it.bias)
        self._h = []
        return out


class BiasCallback(Callback):
    """Top-|nn_eval - mcts_eval| positions per game (10) and per episode
    (20), dumped at game/episode end (bias_callback.cc:37-91)."""

    def __init__(self, out=None, per_game: int = 10, per_episode: int = 20):
        self.out = out or sys.stdout
        self.per_game_cap = per_game
        self.game_heaps = {}
        self.episode_heap = _BoundedMinHeap(per_episode)

    def on_move(self, info: MoveInfo) -> None:
        bias = abs(info.nn_eval - info.mcts_eval)
        self.game_heaps.setdefault(
            info.game_idx, _BoundedMinHeap(self.per_game_cap)).push(bias, info)
        self.episode_heap.push(bias, info)

    def _dump(self, info: MoveInfo) -> None:
        color = "BLACK" if info.color_to_move == BLACK else "WHITE"
        print(f"Color: {color}", file=self.out)
        print("Last Moves: " + " ".join(str(int(m)) for m in info.last_five_moves),
              file=self.out)
        print("Position", file=self.out)
        print(render(info.position), file=self.out)
        print(f"Num Visits: {info.num_visits}", file=self.out)
        print(f"NN Eval: {info.nn_eval}", file=self.out)
        print(f"MCTS Eval: {info.mcts_eval}", file=self.out)
        print(f"NN Outcome: {info.nn_v}", file=self.out)
        print(f"MCTS Outcome: {info.mcts_v}", file=self.out)
        print(f"NN Score: {info.nn_score}", file=self.out)
        print(f"MCTS Score: {info.mcts_score}", file=self.out)
        print(f"Bias: {info.nn_eval - info.mcts_eval}", file=self.out)
        print("----------------------", file=self.out)

    def on_game_end(self, result: GameResult) -> None:
        print(f"Game Result: {result}", file=self.out)
        print("Dumping Most Biased Positions for Game", file=self.out)
        heap = self.game_heaps.pop(result.game_idx, None)
        if heap:
            for item in heap.drain_desc():
                self._dump(item.info)

    def on_episode_end(self) -> None:
        print("Dumping Most Biased Positions for Episode", file=self.out)
        for item in self.episode_heap.drain_desc():
            self._dump(item.info)


def _root_stats(work) -> List[np.ndarray]:
    """Root NN and search estimates, host copies: init_util, w/n,
    init_outcome, w_outcome/n, init_score, score_sum/n, n."""
    n = work.n[:, 0].clamp(min=1).float()
    return [t.cpu().numpy() for t in (
        work.init_util[:, 0], work.w[:, 0] / n, work.init_outcome[:, 0],
        work.w_outcome[:, 0] / n, work.init_score[:, 0], work.score_sum[:, 0] / n,
        work.n[:, 0])]


def play_games(eval_fn: EvalFn, num_games: int, visit_count: int,
               seq_halving: bool, callbacks: Sequence[Callback],
               komi: float = 7.5, k: int = 16, max_depth: int = 32,
               max_moves: int = 600, seed: int = 0,
               reuse_capacity: Optional[int] = None, device="cuda",
               gumbel_noise: Optional[Callable[[int], torch.Tensor]] = None
               ) -> List[GameResult]:
    """Play `num_games` lockstep games to completion on `device` (PlayGames,
    play_games.cc:15-61). Returns per-game results in index order.

    The Gumbel root noise of move m is `gumbel_noise(m)` ([B, 362] standard
    Gumbel) when given, else a draw from a generator on `device` seeded
    `seed`."""
    dev = torch.device(device)
    B = num_games
    if reuse_capacity is None:
        reuse_capacity = max(visit_count // 2, 16)
    generator = torch.Generator(device=dev).manual_seed(seed)
    states = new_state(B, komi, device=dev)
    # An empty init tree (evaluated=False roots are fresh), so every move
    # returns (result, working_tree) for stats and compaction.
    tree = make_tree(B, reuse_capacity, dev)

    gp = SearchParams(n=visit_count, k=k, max_depth=max_depth)
    pp = PuctParams(n=visit_count, root_selection="lcb", max_depth=max_depth)

    done = np.zeros((B,), bool)
    results: List[Optional[GameResult]] = [None] * B

    def finish(games, num_moves):
        bs, ws, _ = score_boards(states)
        bs, ws = bs.cpu().numpy(), ws.cpu().numpy()
        for g in games:
            results[g] = GameResult(
                game_idx=int(g), winner=BLACK if bs[g] > ws[g] else WHITE,
                bscore=float(bs[g]), wscore=float(ws[g]), num_moves=num_moves)
            for cb in callbacks:
                cb.on_game_end(results[g])

    for move_num in range(max_moves):
        if seq_halving:
            noise = (gumbel_noise(move_num) if gumbel_noise is not None
                     else gumbel((B, NUM_MOVES), generator, dev))
            res, work = search_root(states, eval_fn, gp, init_tree=tree,
                                    reuse_capacity=reuse_capacity,
                                    gumbel_noise=noise.to(dev))
        else:
            # Deviation (the JAX package's): the reference reuses the node
            # table across moves for the PUCT kind too (play_games.cc:
            # 46-51); search_root_puct takes no init tree, so PUCT games
            # search fresh each move.
            res, work = search_root_puct(states, eval_fn, pp, return_tree=True)

        moves = res.mcts_move.cpu().numpy()
        stats = _root_stats(work)
        stones_np = states.stones.cpu().numpy()
        last5_np = states.last_moves.cpu().numpy()
        colors_np = states.to_move.cpu().numpy()
        for g in range(B):
            if done[g]:
                continue
            info = MoveInfo(
                game_idx=g, move_num=move_num, color_to_move=int(colors_np[g]),
                position=stones_np[g], last_five_moves=last5_np[g],
                move=int(moves[g]),
                nn_eval=float(stats[0][g]), mcts_eval=float(stats[1][g]),
                nn_v=float(stats[2][g]), mcts_v=float(stats[3][g]),
                nn_score=float(stats[4][g]), mcts_score=float(stats[5][g]),
                num_visits=int(stats[6][g]))
            for cb in callbacks:
                cb.on_move(info)

        states, _ = step(states, res.mcts_move)
        if seq_halving:
            tree = compact_subtree(work, res.mcts_move, reuse_capacity)
        over = is_game_over(states).cpu().numpy()
        newly_done = over & ~done
        if newly_done.any():
            finish(np.flatnonzero(newly_done), move_num + 1)
        done |= over
        if done.all():
            break

    # Score any games that hit max_moves without finishing.
    if not done.all():
        finish(np.flatnonzero(~done), max_moves)

    for cb in callbacks:
        cb.on_episode_end()
    return results  # type: ignore[return-value]
