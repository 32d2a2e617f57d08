"""Training step (port of p3achygo_tpu/train/step.py; reference
python/train.py train_step :50): train-mode forward, compute_losses,
backward, optimizer update, new BN statistics.

Master parameters stay float32; the forward computes in the model's
`dtype` (bf16 casts each weight on use, and autograd takes the gradient
back to the float32 master), so no loss scaling is needed. `grad_norm` is
the global norm of the raw gradients, before any clipping.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from p3achygo_tpu_torch.models.losses import GroundTruth, LossCoeffs, compute_losses
from p3achygo_tpu_torch.train.optimizer import (
    GradientTransformation,
    apply_updates,
    global_norm,
)


class TrainState(NamedTuple):
    """The learner's state. `params` and `batch_stats` are the model's own
    tensors by name (its parameters; its BN running statistics), so a step
    updates the model in place; `opt_state` is the optimizer's."""

    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: dict
    step: int


def batch_stats_of(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's BN running statistics by name."""
    return {k: v for k, v in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def create_train_state(model: torch.nn.Module, tx: GradientTransformation) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(params=params, batch_stats=batch_stats_of(model),
                      opt_state=tx.init(params), step=0)


def make_train_step(model, tx: GradientTransformation, coeffs: LossCoeffs
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor, GroundTruth],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """-> train_step(state, planes, scalars, targets) -> (state, losses).
    The step updates the model's parameters and BN statistics in place;
    the losses are detached scalars (no host sync), `grad_norm` among
    them."""

    def train_step(state: TrainState, planes, scalars, targets: GroundTruth):
        names = list(state.params)
        outputs = model(planes, scalars, train=True)
        losses = compute_losses(outputs, targets, coeffs)
        grads = torch.autograd.grad(losses["loss"], [state.params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(state.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = global_norm(grads)
        return state._replace(opt_state=opt_state, step=state.step + 1), losses

    return train_step
