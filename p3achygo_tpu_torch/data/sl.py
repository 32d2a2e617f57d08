"""SL dataset pipeline: SGF games -> training examples (port of
p3achygo_tpu/data/sl.py).

Replaces cc/data/ (coordinator/worker SGF->TFRecord conversion) and
python/datasets/common/example_generator.py: replays each SGF's main line
through the rules engine and emits one example per position with a
one-hot policy target of the played move, the game result as outcome and
score targets, and zeroed RL-only targets (SL loss coefficients zero them
out, loss_coeffs.py SLCoeffs).

The JAX package replays one game at a time with a per-move B=1 `step`.
Here the games of a batch replay in lockstep, batch-first, on `device`:
move t of every game is one `step` over the batch, a game past its last
move plays passes that nothing records, and each game's examples are the
rows of its own moves, the ones JAX's per-game replay gives.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import re
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from p3achygo_tpu_torch.constants import (
    BLACK,
    NUM_LOCS,
    NUM_MOVES,
    PASS_MOVE,
    WHITE,
)
from p3achygo_tpu_torch.game.board import new_state, step
from p3achygo_tpu_torch.selfplay.records import GameExamples
from p3achygo_tpu_torch.sgf import extract_moves, game_info, parse_sgf

# Games replayed together by iter_sgf_dir and the shard workers.
REPLAY_BATCH = 256


def _result_to_z_margin(result: str):
    """'B+3.5' -> (winner, margin); resign/time -> margin None."""
    m = re.match(r"^([BW])\+(.*)$", result.strip(), re.IGNORECASE)
    if not m:
        return 0, None
    winner = BLACK if m.group(1).upper() == "B" else WHITE
    rest = m.group(2).strip().upper()
    if rest in ("R", "RESIGN", "T", "TIME", "F", ""):
        return winner, None
    try:
        return winner, float(rest)
    except ValueError:
        return winner, None


class SgfGame(NamedTuple):
    moves: list  # [(color, action)] along the main line, cut to max_moves
    winner: int
    margin: Optional[float]
    komi: float


def parse_game(text: str, max_moves: int = 1000) -> Optional[SgfGame]:
    """The host half of sgf_to_examples: None for a game JAX rejects before
    replaying it (not 19x19, fewer than two moves, no winner). Raises what
    the SGF parser raises on malformed text."""
    root = parse_sgf(text)
    info = game_info(root)
    if info["board_size"] != 19:
        return None
    moves = extract_moves(root)[:max_moves]
    if len(moves) < 2:
        return None
    winner, margin = _result_to_z_margin(info["result"])
    if winner == 0:
        return None
    return SgfGame(moves, winner, margin, float(info["komi"]))


def replay_games(games: Sequence[SgfGame], device="cuda"
                 ) -> List[Optional[GameExamples]]:
    """Replay `games` in lockstep on `device` -> each game's SL examples,
    None for a game with an illegal move (a corrupt record)."""
    dev = torch.device(device)
    B = len(games)
    if B == 0:
        return []
    lengths = np.array([len(g.moves) for g in games], np.int64)
    T = int(lengths.max())
    actions = np.full((B, T), PASS_MOVE, np.int64)
    colors = np.full((B, T), BLACK, np.int8)
    for i, g in enumerate(games):
        colors[i, :len(g.moves)] = [c for c, _ in g.moves]
        actions[i, :len(g.moves)] = [a for _, a in g.moves]
    act_t = torch.from_numpy(actions).to(dev)
    col_t = torch.from_numpy(colors).to(dev)
    len_t = torch.from_numpy(lengths).to(dev)
    komi = torch.tensor([g.komi for g in games], dtype=torch.float32, device=dev)
    st = new_state(B, komi, device=dev)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    stones_rows, last_rows = [], []
    for t in range(T):
        live = t < len_t
        # The SGF's colour plays, whoever the board thinks is to move.
        st = st._replace(to_move=torch.where(live, col_t[:, t], st.to_move))
        stones_rows.append(st.stones)
        last_rows.append(st.last_moves)
        st, status = step(st, act_t[:, t])
        bad |= live & (status != 0)
    stones = torch.stack(stones_rows, 1).cpu().numpy()
    last_moves = torch.stack(last_rows, 1).to(torch.int16).cpu().numpy()
    bad = bad.cpu().numpy()
    return [None if bad[i] else _examples(g, stones[i, :len(g.moves)],
                                          last_moves[i, :len(g.moves)])
            for i, g in enumerate(games)]


def _examples(g: SgfGame, stones: np.ndarray, last_moves: np.ndarray
              ) -> GameExamples:
    M = len(g.moves)
    colors = np.array([c for c, _ in g.moves], np.int8)
    pi = np.zeros((M, NUM_MOVES), np.float32)
    pi[np.arange(M), [a for _, a in g.moves]] = 1.0
    pi_aux = np.full((M,), NUM_LOCS, np.int16)
    pi_aux[:-1] = [a for _, a in g.moves[1:]]
    z = np.where(colors == g.winner, 1.0, -1.0).astype(np.float32)
    sm = np.zeros((M,), np.float32)
    if g.margin is not None:
        black_margin = g.margin if g.winner == BLACK else -g.margin
        sm = (black_margin * colors).astype(np.float32)
    zeros = lambda: np.zeros((M,), np.float32)
    return GameExamples(
        stones=np.ascontiguousarray(stones, np.int8),
        last_moves=np.ascontiguousarray(last_moves, np.int16),
        color=colors,
        komi=np.full((M,), g.komi, np.float32),
        pi=pi,
        pi_aux=pi_aux,
        pi_aux_dist=np.zeros((M, NUM_MOVES), np.float32),
        has_pi_aux_dist=np.zeros((M,), bool),
        own=np.zeros((M, NUM_LOCS), np.int8),
        score_margin=sm,
        z=z,
        q6=zeros(), q16=zeros(), q50=zeros(),
        q6_score=zeros(), q16_score=zeros(), q50_score=zeros(),
        weight=np.ones((M,), np.float32),
        mcts_value_dist=np.zeros((M, 51), np.uint16),
    )


def sgf_to_examples(text: str, max_moves: int = 1000, device="cuda"
                    ) -> Optional[GameExamples]:
    """One SGF -> per-move SL examples (None if unusable)."""
    game = parse_game(text, max_moves)
    return None if game is None else replay_games([game], device)[0]


def _sgf_files(path: str) -> List[str]:
    files = []
    for dirpath, _, names in os.walk(path):
        files.extend(os.path.join(dirpath, n) for n in sorted(names)
                     if n.endswith(".sgf"))
    return files


def _examples_of_files(files: Sequence[str], device, errors: Optional[list] = None
                       ) -> Iterator[Optional[GameExamples]]:
    """Each file's examples in file order (None for an unusable one),
    replayed REPLAY_BATCH games at a time; a file that does not open or
    parse appends its path to `errors` and yields nothing."""
    for lo in range(0, len(files), REPLAY_BATCH):
        parsed = []
        for path in files[lo:lo + REPLAY_BATCH]:
            try:
                with open(path) as f:
                    parsed.append(parse_game(f.read()))
            except (ValueError, IndexError, OSError):
                if errors is not None:
                    errors.append(path)
        usable = [g for g in parsed if g is not None]
        replayed = iter(replay_games(usable, device))
        for g in parsed:
            yield None if g is None else next(replayed)


def iter_sgf_dir(path: str, device="cuda") -> Iterator[GameExamples]:
    """Stream SL examples from every .sgf under `path` (Coordinator/Worker
    parity, cc/data/coordinator.h:11-48, single-process)."""
    for ex in _examples_of_files(_sgf_files(path), device):
        if ex is not None:
            yield ex


def build_sl_replay(sgf_dir: str, replay, limit_games: Optional[int] = None,
                    device="cuda") -> int:
    """Fill a ReplayBuffer from an SGF corpus; returns #games ingested."""
    count = 0
    for ex in iter_sgf_dir(sgf_dir, device):
        replay.add_game(ex)
        count += 1
        if limit_games and count >= limit_games:
            break
    return count


# ---------------------------------------------------------------------------
# Multi-worker shard writer (Coordinator/Worker, cc/data/coordinator.h:11-48
# + worker.cc): the coordinator hands SGF files to N workers, which write
# TFRecord shards and report their counts. Here a spawn-context process
# pool: each worker replays its slice of the files on the device it is
# given and writes `sl_shard_%04d_w%d.tfrecord.zz` shards; the parent writes
# an `sl_shards.done` marker (data/filename_format.h:14-15) with the
# aggregate counts.
# ---------------------------------------------------------------------------

def _sl_worker(args):
    worker_id, files, out_dir, examples_per_shard, device = args
    from p3achygo_tpu_torch.data.export import examples_to_records
    from p3achygo_tpu_torch.data.tfrecord import write_records

    shard, pending, shards = 0, [], []
    games = examples = 0
    failed: list = []

    def flush():
        nonlocal shard, pending
        if not pending:
            return
        name = f"sl_shard_{shard:04d}_w{worker_id}.tfrecord.zz"
        write_records(os.path.join(out_dir, name), pending, zlib_level=6)
        shards.append(name)
        shard += 1
        pending = []

    unusable = 0
    for ex in _examples_of_files(files, device, failed):
        if ex is None:
            unusable += 1
            continue
        recs = examples_to_records(ex, device)
        games += 1
        examples += len(recs)
        pending.extend(recs)
        if len(pending) >= examples_per_shard:
            flush()
    flush()
    return dict(worker=worker_id, games=games, examples=examples,
                errors=unusable + len(failed), shards=shards)


def build_sl_shards(sgf_dir: str, out_dir: str, num_workers: int = 4,
                    examples_per_shard: int = 4096, device="cuda") -> dict:
    """Fan SGF->example work over `num_workers` processes, each replaying
    and exporting on `device`; write TFRecord shards + an `sl_shards.done`
    marker. Returns the aggregate report."""
    files = _sgf_files(sgf_dir)
    os.makedirs(out_dir, exist_ok=True)
    slices = [files[i::num_workers] for i in range(num_workers)]
    work = [(i, s, out_dir, examples_per_shard, str(device))
            for i, s in enumerate(slices) if s]
    if not work:
        reports = []
    elif len(work) == 1:
        reports = [_sl_worker(work[0])]
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(len(work)) as pool:
            reports = pool.map(_sl_worker, work)
    agg = dict(
        files=len(files),
        games=sum(r["games"] for r in reports),
        examples=sum(r["examples"] for r in reports),
        errors=sum(r["errors"] for r in reports),
        shards=sorted(n for r in reports for n in r["shards"]),
        workers=len(work),
    )
    with open(os.path.join(out_dir, "sl_shards.done"), "w") as f:
        json.dump(agg, f)
    return agg
