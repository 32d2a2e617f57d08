"""Replay batch -> model inputs + GroundTruth, on the device (port of
p3achygo_tpu/data/pipeline.py; reference python/transforms.py expand :488).

Rebuilds the input planes from the recorded positions (chains by
`compute_chains`, planes by the batched featurizer, whose liberties come
from the liberty kernel on a card), applies a D4 symmetry per example to
every spatial tensor (stones, last moves, pi, pi_aux, pi_aux_dist, own),
and builds the score one-hot and outcome targets (transforms.py:244-258).
Ladder planes stay zero, as in self-play.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from p3achygo_tpu_torch.constants import NUM_SCORE_LOGITS, SCORE_INFLECTION_POINT
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import compute_chains, new_state
from p3achygo_tpu_torch.game.symmetry import (
    NUM_SYMMETRIES,
    apply_symmetry_action,
    apply_symmetry_grid_batch,
    apply_symmetry_policy_batch,
)
from p3achygo_tpu_torch.models.losses import GroundTruth


def prepare_batch(batch: Dict[str, np.ndarray], augment: bool = True,
                  syms: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> Tuple[torch.Tensor, torch.Tensor, GroundTruth]:
    """Replay rows (`ReplayBuffer.sample`'s dict of arrays or tensors) ->
    (planes f32[N, 19, 19, 15], scalars f32[N, 8], GroundTruth) on `device`.

    With `augment`, example i is transformed by symmetry `syms[i]`, drawn
    uniformly from {0..7} with `generator` unless given."""
    dev = torch.device(device)
    # uint16 (the value histogram) widens on the host: torch has few uint16 ops.
    b = {k: torch.as_tensor(np.asarray(v, np.int32) if getattr(v, "dtype", None) == np.uint16
                            else v).to(dev)
         for k, v in batch.items()}
    N = b["stones"].shape[0]
    stones, last_moves = b["stones"].to(torch.int8), b["last_moves"].long()
    pi, pi_aux, pi_aux_dist = b["pi"], b["pi_aux"].long(), b["pi_aux_dist"]
    own = b["own"].float()

    if augment:
        if syms is None:
            syms = torch.randint(0, NUM_SYMMETRIES, (N,), generator=generator,
                                 device=dev)
        syms = syms.to(dev)
        stones = apply_symmetry_grid_batch(stones, syms)
        last_moves = apply_symmetry_action(last_moves, syms)
        pi = apply_symmetry_policy_batch(pi, syms)
        pi_aux = apply_symmetry_action(pi_aux, syms)
        pi_aux_dist = apply_symmetry_policy_batch(pi_aux_dist, syms)
        own = apply_symmetry_grid_batch(own, syms)

    states = new_state(N, device=dev, history=0)._replace(
        stones=stones,
        chain_id=compute_chains(stones),
        last_moves=last_moves.to(torch.int32),
        to_move=b["color"].to(torch.int8),
        komi=b["komi"].float(),
    )
    planes, scalars = batched_features(states)

    score_idx = (torch.floor(b["score_margin"]).long() + SCORE_INFLECTION_POINT
                 ).clamp(0, NUM_SCORE_LOGITS - 1)
    score_one_hot = torch.nn.functional.one_hot(score_idx, NUM_SCORE_LOGITS).float()
    win = (b["z"] > 0).long()
    outcome = torch.nn.functional.one_hot(win, 2).float()  # [loss, win]

    mvd = b["mcts_value_dist"]
    targets = GroundTruth(
        policy=pi,
        policy_aux=pi_aux,
        score=b["score_margin"],
        score_one_hot=score_one_hot,
        game_outcome=outcome,
        own=own,
        q6=b["q6"], q16=b["q16"], q50=b["q50"],
        q6_score=b["q6_score"], q16_score=b["q16_score"],
        q50_score=b["q50_score"],
        policy_aux_dist=pi_aux_dist,
        has_pi_aux_dist=b["has_pi_aux_dist"].bool(),
        mcts_value_dist=mvd.float(),
        has_mcts_value_dist=mvd.sum(dim=-1) > 0,
    )
    return planes, scalars, targets
