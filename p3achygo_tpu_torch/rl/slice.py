"""Minimum end-to-end actor-learner slice (port of p3achygo_tpu/rl/slice.py;
SURVEY.md §7 stage 5).

One process, one device: single-tier self-play fills the replay buffer
(finished games scored with Benson pass-alive analysis and turned into
training rows on the host), the learner trains on sampled batches, and
self-play then serves the new weights. Randomness: the network's initial
weights from a CPU generator seeded `seed`, every self-play, reset and
augmentation draw from one device generator seeded `seed + 1`, replay
sampling from numpy's default_rng(seed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.data.replay import ReplayBuffer
from p3achygo_tpu_torch.game.board import map_state, new_state
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.selfplay.loop import (
    SelfplayConfig,
    final_scores,
    finished_mask,
    make_aux,
    make_game_buffer,
    reset_finished,
    selfplay_step,
)
from p3achygo_tpu_torch.selfplay.records import finalize_game
from p3achygo_tpu_torch.train.optimizer import sgd_nesterov
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step

# The GameBuffer fields finalize_game reads.
_RECORD_FIELDS = ("stones", "last_moves", "to_move", "pi", "move", "root_q_outcome",
                  "root_score", "kld", "trainable", "mcts_value_dist")


@dataclasses.dataclass
class SliceConfig:
    model: str = "b8c64"
    batch_size: int = 32  # selfplay boards in lockstep
    train_batch_size: int = 64
    search: SearchParams = dataclasses.field(
        default_factory=lambda: SearchParams(n=16, k=4, noise_scale=1.0))
    selfplay: SelfplayConfig = dataclasses.field(default_factory=SelfplayConfig)
    lr: float = 1e-2
    dtype: str = "bfloat16"
    seed: int = 0


class RLSlice:
    """Owns model, self-play state and replay; exposes self-play and train
    primitives. Runs on `device` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: SliceConfig, device="cuda"):
        self.cfg = cfg
        self.device = dev = torch.device(device)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.model = build_model(get_config(cfg.model), dtype, dev)
        init_params(self.model, torch.Generator().manual_seed(cfg.seed))
        self.replay = ReplayBuffer(capacity=1 << 18, seed=cfg.seed)
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1)

        self.tx = sgd_nesterov(cfg.lr)
        self.train_state = create_train_state(self.model, self.tx)
        self._train_step = make_train_step(self.model, self.tx, LossCoeffs.rl())

        B = cfg.batch_size
        sp = cfg.selfplay
        self.states = new_state(B, sp.komi, device=dev)
        self.buf = make_game_buffer(B, sp.max_game_len, dev)
        self.aux = make_aux(B, self.generator, sp.max_raw_policy_moves, dev)
        self.reuse_capacity = cfg.search.n + 2 if sp.tree_reuse else 0
        self.tree = make_tree(B, self.reuse_capacity, dev) if sp.tree_reuse else None
        self._eval_fn = None

    def refresh_weights(self) -> None:
        """(Re)build the evaluator self-play uses, from the model's current
        weights."""
        self._eval_fn = make_eval_fn(self.model)

    def play_moves(self, num_moves: int) -> int:
        """Advance all boards `num_moves` plies; harvest finished games.
        Returns the number of finished games harvested."""
        if self._eval_fn is None:
            self.refresh_weights()
        harvested = 0
        for _ in range(num_moves):
            out = selfplay_step(self.states, self.buf, self.aux, self._eval_fn,
                                self.cfg.search, self.cfg.selfplay,
                                selected_tier=True, generator=self.generator,
                                reuse_tree=self.tree,
                                reuse_capacity=self.reuse_capacity)
            if self.tree is not None:
                self.states, self.buf, self.aux, self.tree = out
            else:
                self.states, self.buf, self.aux = out
            done = finished_mask(self.states, self.cfg.selfplay)
            if bool(done.any()):
                harvested += self._harvest(done)
        return harvested

    def _harvest(self, done: torch.Tensor) -> int:
        """Score the finished boards, add their trainable moves to the
        replay buffer, and reset them. The records move to the host once
        per harvest."""
        sp = self.cfg.selfplay
        idx = done.nonzero()[:, 0]
        finished = map_state(lambda t: t[idx], self.states)
        bs, ws, own = (t.cpu().numpy() for t in final_scores(finished))
        rec = {f: getattr(self.buf, f)[idx].cpu().numpy() for f in _RECORD_FIELDS}
        counts = finished.move_count.cpu().numpy()
        komi = finished.komi.cpu().numpy()
        for i in range(idx.shape[0]):
            ex = finalize_game(**{f: rec[f][i] for f in _RECORD_FIELDS},
                               num_moves=min(int(counts[i]), sp.max_game_len),
                               black_score=float(bs[i]), white_score=float(ws[i]),
                               ownership=own[i], komi=float(komi[i]))
            if ex is not None:
                self.replay.add_game(ex)
        out = reset_finished(self.states, self.buf, self.aux, done, sp.komi,
                             generator=self.generator,
                             max_raw_policy_moves=sp.max_raw_policy_moves,
                             reuse_tree=self.tree)
        if self.tree is not None:
            self.states, self.buf, self.aux, self.tree = out
        else:
            self.states, self.buf, self.aux = out
        return int(idx.shape[0])

    def train_steps(self, num_steps: int, window: Optional[int] = None
                    ) -> Dict[str, float]:
        """Run `num_steps` learner updates from the replay buffer; self-play
        then rebinds to the new weights. Returns the last step's losses."""
        losses = None
        for _ in range(num_steps):
            batch = self.replay.sample(self.cfg.train_batch_size, window)
            planes, scalars, targets = prepare_batch(
                batch, augment=True, generator=self.generator, device=self.device)
            self.train_state, losses = self._train_step(
                self.train_state, planes, scalars, targets)
        self._eval_fn = None  # self-play must rebind to the new weights
        return {k: float(v) for k, v in losses.items()} if losses else {}
