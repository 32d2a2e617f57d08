"""Decoupled actor/learner workers over the artifact store bus (port of
p3achygo_tpu/rl/workers.py).

Mirrors the reference's distributed RL deployment: selfplay workers
(cc/selfplay/main.cc) and the trainer (python/rl_loop/train_sp_eval.py)
run as separate processes or machines that only exchange artifacts
through a store: models flow trainer -> workers, chunks flow workers ->
trainer (train_sp_eval.py:100-230, sp_loop.py:60-140, fs_utils.py). The
bus is a `data/store.py` store (local dir / NFS / GCS) and each worker
wraps a GenerationLoop:

- `SelfplayActor` polls the bus for a newer golden model, loads its
  weights into the loop's golden network in place, plays games, and
  publishes chunks.
- `Learner` ingests newly done chunks into its replay, trains and gates
  a candidate (GenerationLoop.train_and_gate, which saves the candidate
  before the eval, train_sp_eval.py:213-215), and publishes the resulting
  golden to models/.

Models on the bus are the port's checkpoints: models/model_%04d holding
state.pt with {"model": state_dict} (train/checkpoint.py save_named).
Chunks are the reference's TFRecord format (data/export.py), which the
JAX package reads and writes too.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Optional

from p3achygo_tpu_torch.data.export import read_game_chunk, write_game_chunk
from p3achygo_tpu_torch.data.store import (
    SP_CHUNKS_DIR,
    list_done_chunks,
    model_name,
    most_recent_model,
)
from p3achygo_tpu_torch.rl.config import RunConfig
from p3achygo_tpu_torch.rl.loop import GenerationLoop
from p3achygo_tpu_torch.train.checkpoint import restore_checkpoint, save_named


class SelfplayActor:
    """Selfplay worker: pull golden weights from the bus, play, push
    chunks (sp_loop.py loop + nn/engine model reload semantics)."""

    def __init__(self, cfg: RunConfig, store, worker_id: str = "w0",
                 scratch_dir: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.store = store
        self.worker_id = worker_id
        self.scratch = scratch_dir or tempfile.mkdtemp(prefix="actor_")
        self.loop = GenerationLoop(cfg, root_dir=self.scratch, seed=seed,
                                   device=device)
        self.model_gen = -1
        self._pending: List = []
        self._batch_id = 0
        self.loop.game_sink = self._pending.append

    def sync_model(self) -> bool:
        """Adopt the newest published golden model; True if swapped."""
        latest = most_recent_model(self.store)
        if latest <= self.model_gen:
            return False
        src = self.store.local_path(model_name(latest))
        if src is None or not os.path.isdir(src):
            src = self.store.get(model_name(latest), os.path.join(
                self.scratch, f"pull_model_{latest:04d}"))
        state = restore_checkpoint(src, map_location=self.loop.device)
        # In place: the golden module is what the loop's evaluator serves.
        self.loop.golden.load_state_dict(state["model"])
        self.model_gen = latest
        self.loop.gen = latest  # n/k growth follows the published gen
        self.loop._sp = None  # rebind the search to this generation's n/k
        return True

    def play_and_publish(self, num_games: int) -> str:
        """Play `num_games`, publish ONE chunk (+ .done) to the bus; returns
        its store name ('' when no game finished)."""
        self._pending.clear()
        self.loop.selfplay_games(num_games)
        if not self._pending:
            return ""
        path = write_game_chunk(os.path.join(self.scratch, "chunks"),
                                list(self._pending), gen=max(self.model_gen, 0),
                                batch_id=self._batch_id, worker_id=self.worker_id,
                                device=self.loop.device)
        name = f"{SP_CHUNKS_DIR}/{os.path.basename(path)}"
        self.store.put(path, name, done=True)
        self._batch_id += 1
        self._pending.clear()
        return name

    def run(self, iterations: int, games_per_iter: int, poll_s: float = 0.0):
        """sp_loop.py:60-140 main loop: sync -> play -> publish."""
        for _ in range(iterations):
            self.sync_model()
            self.play_and_publish(games_per_iter)
            if poll_s:
                time.sleep(poll_s)


class Learner:
    """Trainer worker: ingest chunks from the bus, train + gate, publish
    goldens (train_sp_eval.py:100-230 with the store as the file bus)."""

    def __init__(self, cfg: RunConfig, store, run_dir: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.store = store
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="learner_")
        self.loop = GenerationLoop(cfg, root_dir=self.run_dir, seed=seed,
                                   device=device)
        self._seen_chunks: set = set()

    def publish_golden(self):
        """Publish the current golden as models/model_%04d (+ .done)."""
        gen = self.loop.gen
        local = save_named(self.run_dir, f"pub_model_{gen:04d}",
                           {"model": self.loop.golden.state_dict()})
        self.store.put(local, model_name(gen), done=True)

    def ingest_new_chunks(self) -> int:
        """Pull newly done selfplay chunks into the replay; returns the
        number of examples ingested (tf_record_watcher + shuffle.py poll)."""
        total = 0
        for name in list_done_chunks(self.store, SP_CHUNKS_DIR):
            if name in self._seen_chunks:
                continue
            key = f"{SP_CHUNKS_DIR}/{name}"
            src = self.store.local_path(key)
            if src is None or not os.path.exists(src):
                src = self.store.get(key, os.path.join(self.run_dir, "in_chunks", name))
            ex = read_game_chunk(src)
            if len(ex):
                self.loop.replay.add_game(ex)
                total += len(ex)
            self._seen_chunks.add(name)
        return total

    def wait_for_examples(self, min_examples: int, timeout_s: float = 300.0,
                          poll_s: float = 0.5) -> int:
        """Ingest until the replay holds `min_examples` or `timeout_s`
        passes; returns the examples ingested."""
        got = self.ingest_new_chunks()
        deadline = time.time() + timeout_s
        while len(self.loop.replay) < min_examples and time.time() < deadline:
            time.sleep(poll_s)
            got += self.ingest_new_chunks()
        return got

    def train_generation(self, eval_gating: bool = True) -> dict:
        """One trainer generation over bus-fed data; publishes the golden
        (candidate-first inside train_and_gate)."""
        out = self.loop.train_and_gate(eval_gating=eval_gating)
        self.publish_golden()
        return out
