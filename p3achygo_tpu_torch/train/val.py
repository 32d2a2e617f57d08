"""Validation metrics (port of p3achygo_tpu/train/val.py; reference
python/train.py val :1038): loss breakdown + accuracy metrics over a
held-out batch stream."""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from p3achygo_tpu_torch.models.losses import GroundTruth, LossCoeffs, compute_losses


def batch_metrics(outputs, targets: GroundTruth) -> Dict[str, torch.Tensor]:
    """Accuracy-style metrics for one batch."""
    pred_move = outputs.pi_logits.argmax(dim=-1)
    true_move = targets.policy.argmax(dim=-1)
    pol_acc = (pred_move == true_move).float().mean()
    top5 = outputs.pi_logits.topk(5, dim=-1).indices
    pol_acc5 = (top5 == true_move[:, None]).any(dim=-1).float().mean()

    pred_win = outputs.outcome_probs[:, 1] > 0.5
    true_win = targets.game_outcome[:, 1] > 0.5
    outcome_acc = (pred_win == true_win).float().mean()

    score_values = torch.arange(outputs.score_probs.shape[-1], dtype=torch.float32,
                                device=outputs.score_probs.device) - 400.0 + 0.5
    pred_score = (outputs.score_probs * score_values[None, :]).sum(dim=-1)
    score_mae = (pred_score - targets.score).abs().mean()
    own_mae = (outputs.ownership - targets.own).abs().mean()
    return dict(policy_acc=pol_acc, policy_acc_top5=pol_acc5,
                outcome_acc=outcome_acc, score_mae=score_mae, own_mae=own_mae)


@torch.no_grad()
def validate(model, batches: Iterable, coeffs: LossCoeffs) -> Dict[str, float]:
    """Average losses + metrics of the model (BN from running statistics)
    over an iterable of (planes, scalars, GroundTruth) batches."""
    totals: Dict[str, float] = {}
    count = 0
    for planes, scalars, targets in batches:
        outputs = model(planes, scalars)
        out = {**compute_losses(outputs, targets, coeffs), **batch_metrics(outputs, targets)}
        for key, val in out.items():
            totals[key] = totals.get(key, 0.0) + float(val)
        count += 1
    return {k: v / max(count, 1) for k, v in totals.items()}
