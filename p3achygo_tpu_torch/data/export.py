"""Chunk export: GameExamples -> tensorflow.Example TFRecord chunks and back
(port of p3achygo_tpu/data/export.py).

Keeps the reference's file formats: chunk naming
gen%03d_b%03d_g%03d_n%05d_t%d_%s.tfrecord.zz (cc/data/filename_format.h:
11-12) plus `.done` markers (filename_format.h:14-15) and golden chunks
chunk_%04d.tfrecord.zz + .size (cc/shuffler/filename_format.h:42-45). The
bytes written are the JAX package's, so either package reads the other's
chunks.
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from p3achygo_tpu_torch.data.example import decode_example, make_tf_example
from p3achygo_tpu_torch.data.tfrecord import read_records, write_records
from p3achygo_tpu_torch.game.board import compute_chains
from p3achygo_tpu_torch.ops.liberties import point_liberties_batch
from p3achygo_tpu_torch.selfplay.records import GameExamples

CHUNK_FORMAT = "gen%03d_b%03d_g%03d_n%05d_t%d_%s.tfrecord.zz"
GOLDEN_CHUNK_FORMAT = "chunk_%04d.tfrecord.zz"


def liberty_planes(stones: np.ndarray, device="cuda") -> np.ndarray:
    """int32[M, 361] liberties of each point's chain for the boards
    `stones` int8[M, 361]: `compute_chains` and one `point_liberties_batch`
    over all M boards on `device` (the liberty kernel on a card)."""
    s = torch.tensor(stones, dtype=torch.int8, device=device)
    return point_liberties_batch(s, compute_chains(s)).cpu().numpy()


def examples_to_records(ex: GameExamples, device="cuda") -> List[bytes]:
    """Serialize every move of a finalized game to Example protos.

    The liberty/ladder planes are derivable from `stones`; the exporter
    recomputes them (one batch per game on `device`) so offline consumers
    get the full reference schema. Training from the in-memory replay
    featurizes on the device and does not use this path."""
    libs = liberty_planes(ex.stones, device)
    recs = []
    for i in range(len(ex)):
        s = ex.stones[i]
        lib = libs[i]
        recs.append(make_tf_example(
            stones=s,
            last_moves=ex.last_moves[i],
            stones_atari=np.where(lib == 1, s, 0).astype(np.int8),
            stones_two_lib=np.where(lib == 2, s, 0).astype(np.int8),
            stones_three_lib=np.where(lib == 3, s, 0).astype(np.int8),
            stones_ladder=np.zeros_like(s),
            pi=ex.pi[i],
            pi_aux=int(ex.pi_aux[i]),
            pi_aux_dist=ex.pi_aux_dist[i],
            ownership=(ex.own[i] * ex.color[i]).astype(np.int8),  # black view
            score_margin_black=float(ex.score_margin[i] * ex.color[i]),
            mcts_value_dist=ex.mcts_value_dist[i].astype(np.uint32),
            q6=float(ex.q6[i]), q16=float(ex.q16[i]), q50=float(ex.q50[i]),
            q6_score=float(ex.q6_score[i]), q16_score=float(ex.q16_score[i]),
            q50_score=float(ex.q50_score[i]),
            color=int(ex.color[i]), komi=float(ex.komi[i])))
    return recs


def write_game_chunk(out_dir: str, games: List[GameExamples], gen: int,
                     batch_id: int = 0, worker_id: str = "w0",
                     device="cuda") -> str:
    """Write one selfplay chunk, then its .done marker; returns the chunk
    path."""
    os.makedirs(out_dir, exist_ok=True)
    recs: List[bytes] = []
    for g in games:
        recs.extend(examples_to_records(g, device))
    name = CHUNK_FORMAT % (gen, batch_id, len(games), len(recs),
                           int(time.time()), worker_id)
    path = os.path.join(out_dir, name)
    write_records(path, recs, zlib_level=6)
    with open(path + ".done", "w") as f:
        f.write("")
    return path


def records_to_examples(recs: List[bytes]) -> GameExamples:
    """Decode Example protos back into one columnar GameExamples batch
    (inverse of examples_to_records; the learner's chunk-ingest path).

    Fields not stored in the reference schema are reconstructed:
    z = sign(score_margin) (margins are never 0 under fractional komi),
    sampling weight defaults to 1.0 (the recorder applies weights before
    writing), has_pi_aux_dist = any(pi_aux_dist != 0)."""
    cols: dict = {k: [] for k in (
        "stones", "last_moves", "color", "komi", "pi", "pi_aux",
        "pi_aux_dist", "own", "score_margin", "q6", "q16", "q50",
        "q6_score", "q16_score", "q50_score", "mcts_value_dist")}
    for rec in recs:
        d = decode_example(rec)
        cols["stones"].append(np.frombuffer(d["board"], np.int8))
        cols["last_moves"].append(np.frombuffer(d["last_moves"], np.int16))
        color = int(np.frombuffer(d["color"], np.int8)[0])
        cols["color"].append(color)
        cols["komi"].append(float(d["komi"][0]))
        cols["pi"].append(np.frombuffer(d["pi"], np.float32))
        cols["pi_aux"].append(int(np.frombuffer(d["pi_aux"], np.int16)[0]))
        cols["pi_aux_dist"].append(np.frombuffer(d["pi_aux_dist"], np.float32))
        own_black = np.frombuffer(d["own"], np.int8)
        cols["own"].append((own_black * color).astype(np.int8))
        # Stored from the mover's view, as GameExamples keeps it.
        cols["score_margin"].append(float(d["score_margin"][0]))
        for k in ("q6", "q16", "q50", "q6_score", "q16_score", "q50_score"):
            cols[k].append(float(d[k][0]))
        cols["mcts_value_dist"].append(
            np.frombuffer(d["mcts_value_dist"], np.uint32).astype(np.uint16))
    margin = np.asarray(cols["score_margin"], np.float32)
    pad = np.stack(cols["pi_aux_dist"]) if cols["pi_aux_dist"] \
        else np.zeros((0, 362), np.float32)
    return GameExamples(
        stones=np.stack(cols["stones"]) if recs else np.zeros((0, 361), np.int8),
        last_moves=np.stack(cols["last_moves"]),
        color=np.asarray(cols["color"], np.int8),
        komi=np.asarray(cols["komi"], np.float32),
        pi=np.stack(cols["pi"]),
        pi_aux=np.asarray(cols["pi_aux"], np.int16),
        pi_aux_dist=pad,
        has_pi_aux_dist=(np.abs(pad).sum(-1) > 0),
        own=np.stack(cols["own"]),
        score_margin=margin,
        z=np.where(margin > 0, 1.0, -1.0).astype(np.float32),
        q6=np.asarray(cols["q6"], np.float32),
        q16=np.asarray(cols["q16"], np.float32),
        q50=np.asarray(cols["q50"], np.float32),
        q6_score=np.asarray(cols["q6_score"], np.float32),
        q16_score=np.asarray(cols["q16_score"], np.float32),
        q50_score=np.asarray(cols["q50_score"], np.float32),
        weight=np.ones((len(recs),), np.float32),
        mcts_value_dist=np.stack(cols["mcts_value_dist"]),
    )


def read_game_chunk(path: str) -> GameExamples:
    """Read a .tfrecord(.zz) chunk back into GameExamples."""
    return records_to_examples(list(read_records(path)))


def write_golden_chunk(out_dir: str, records: List[bytes], gen: int) -> str:
    """Golden chunk + .size sidecar (ChunkManager::ShuffleAndFlush parity)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, GOLDEN_CHUNK_FORMAT % gen)
    write_records(path, records, zlib_level=6)
    with open(path + ".size", "w") as f:
        f.write(str(len(records)))
    return path
