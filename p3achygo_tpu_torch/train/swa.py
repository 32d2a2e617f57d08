"""Stochastic weight averaging + BN refresh (port of
p3achygo_tpu/train/swa.py; reference python/weight_snapshot.py:11 and
rl_loop/model_utils.py:31-116): snapshots chain-averaged with momentum
0.75, BatchNorm statistics recomputed by train-mode forwards before
export."""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

Tensors = Dict[str, torch.Tensor]


@torch.no_grad()
def swa_average(avg_params: Tensors, new_params: Tensors,
                momentum: float = 0.75) -> Tensors:
    """avg <- momentum * avg + (1 - momentum) * new (model_utils.py:31-39),
    as new tensors."""
    return {k: momentum * a + (1.0 - momentum) * new_params[k]
            for k, a in avg_params.items()}


class SnapshotManager:
    """Collects periodic weight snapshots during training
    (weight_snapshot.py:11-40). Snapshots are copies: the model's own
    parameters change in place as training goes on."""

    def __init__(self, interval: int = 1000, momentum: float = 0.75):
        self.interval = interval
        self.momentum = momentum
        self.avg: Optional[Tensors] = None
        self._last_step = -1

    def maybe_snapshot(self, step: int, params: Tensors) -> None:
        if step // self.interval > self._last_step // self.interval or \
                self.avg is None:
            self.avg = ({k: p.detach().clone() for k, p in params.items()}
                        if self.avg is None
                        else swa_average(self.avg, params, self.momentum))
        self._last_step = step

    def final(self, params: Tensors) -> Tensors:
        if self.avg is None:
            return {k: p.detach().clone() for k, p in params.items()}
        return swa_average(self.avg, params, self.momentum)


@torch.no_grad()
def recompute_batch_stats(model, batches: Iterable, num_passes: int = 64) -> int:
    """Refresh the model's BN running statistics in place with train-mode
    forwards and no gradient (model_utils.py:42-116; no stat reset), over
    at most `num_passes` (planes, scalars) batches. Load the averaged
    weights into the model first. Returns the number of passes run."""
    count = 0
    for planes, scalars in batches:
        model(planes, scalars, train=True)
        count += 1
        if count >= num_passes:
            break
    return count
