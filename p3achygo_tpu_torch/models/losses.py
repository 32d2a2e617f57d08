"""Training losses (port of p3achygo_tpu/models/losses.py; reference
python/model.py compute_losses :1297-1520 and python/loss_coeffs.py).

The same 18 entries as the JAX function, term for term: the `where(t > 0)`
of the KL divergence, the clip at 50 of the sparse cross-entropy, and every
`stop_gradient` of the v1 terms as `.detach()`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

from p3achygo_tpu_torch.models.blocks import group_mean


@dataclasses.dataclass(frozen=True)
class LossCoeffs:
    """Loss weights (loss_coeffs.py:7-48)."""

    w_pi: float
    w_pi_aux: float
    w_val: float
    w_outcome: float
    w_score: float
    w_own: float
    w_q6: float
    w_q16: float
    w_q50: float
    w_gamma: float
    w_q_err: float = 0.0
    w_q_score: float = 0.0
    w_q_score_err: float = 0.0
    w_pi_soft: float = 0.0
    w_pi_optimistic: float = 0.0
    w_mcts_dist: float = 0.0

    @staticmethod
    def sl():
        return LossCoeffs(1.0, 0.15, 1.0, 1.5, 0.02, 0, 0, 0, 0, 0.005)

    @staticmethod
    def rl():
        return LossCoeffs(1.0, 0.15, 1.0, 1.5, 0.02, 0.45, 0.7, 0.4, 0.3,
                          0.005, 3.0, 0.2, 0.2, 4.0, 1.0, 0.125)


class GroundTruth(NamedTuple):
    """Training targets (model.py:55-77). All [N, ...]."""

    policy: torch.Tensor  # f32[N, 362] improved-policy probs
    policy_aux: torch.Tensor  # int64[N] next-move encoding
    score: torch.Tensor  # f32[N] margin for the current player
    score_one_hot: torch.Tensor  # f32[N, 800]
    game_outcome: torch.Tensor  # f32[N, 2] one-hot {loss, win}
    own: torch.Tensor  # f32[N, 361] in [-1, 1], current-player perspective
    q6: torch.Tensor  # f32[N]
    q16: torch.Tensor
    q50: torch.Tensor
    q6_score: torch.Tensor
    q16_score: torch.Tensor
    q50_score: torch.Tensor
    policy_aux_dist: torch.Tensor  # f32[N, 362] next-move search dist
    has_pi_aux_dist: torch.Tensor  # bool[N]
    mcts_value_dist: torch.Tensor  # f32[N, 51] visit-count histogram
    has_mcts_value_dist: torch.Tensor  # bool[N]


def _kld(target_probs, pred_probs, eps=1e-10):
    """KL(target || pred) per example; zero-target terms drop out."""
    t = target_probs.clamp(0.0, 1.0)
    return torch.where(t > 0, t * (torch.log(t + eps) - torch.log(pred_probs + eps)),
                       0.0).sum(dim=-1)


def _softmax_xent_int(labels, logits):
    """Sparse cross-entropy from logits, per example."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def _xent_probs(target_probs, logits):
    return -(target_probs * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def _huber(target, pred, delta=1.0):
    err = pred - target
    a = err.abs()
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def compute_losses(outputs, targets: GroundTruth, w: LossCoeffs, group=None
                   ) -> Dict[str, torch.Tensor]:
    """Total + per-component losses (model.py:1297-1448 + v1_loss_terms).
    With a data-parallel process `group` (ranks holding equal shares of
    the batch), every batch mean is the mean over the whole batch."""
    eps = 1e-6
    mean = torch.mean if group is None else (lambda x: group_mean(torch.mean(x), group))

    # Policy: KLD(target, softmax(pi_logits)).
    policy_loss = mean(_kld(targets.policy, torch.softmax(outputs.pi_logits, dim=-1)))

    # Aux policy: per example either dist-KLD (has dist) or sparse CE at
    # 0.6x weight (model.py:1328-1345).
    has_dist = targets.has_pi_aux_dist.float()
    pi_aux_probs = torch.softmax(outputs.pi_logits_aux, dim=-1)
    aux_dist_loss = mean(has_dist * _kld(targets.policy_aux_dist, pi_aux_probs))
    per_ex_scce = _softmax_xent_int(targets.policy_aux,
                                    outputs.pi_logits_aux).clamp(0.0, 50.0)
    aux_scalar_loss = mean((1.0 - has_dist) * per_ex_scce)

    outcome_loss = mean(_xent_probs(targets.game_outcome, outputs.outcome_logits))
    q6_loss = mean((targets.q6 - outputs.q6) ** 2)
    q16_loss = mean((targets.q16 - outputs.q16) ** 2)
    q50_loss = mean((targets.q50 - outputs.q50) ** 2)

    score_probs = torch.softmax(outputs.score_logits, dim=-1)
    score_pdf_loss = mean(_xent_probs(targets.score_one_hot, outputs.score_logits))
    score_cdf_loss = mean(((torch.cumsum(targets.score_one_hot, dim=1)
                            - torch.cumsum(score_probs, dim=1)) ** 2).sum(dim=1))

    own_loss = mean((targets.own - outputs.ownership) ** 2)
    gamma = outputs.gamma[:, 0]
    gamma_loss = mean(gamma * gamma) * w.w_gamma

    val_loss = (
        w.w_val * (w.w_outcome * outcome_loss + w.w_q6 * q6_loss
                   + w.w_q16 * q16_loss + w.w_q50 * q50_loss
                   + w.w_score * score_pdf_loss + w.w_own * own_loss)
        + w.w_score * score_cdf_loss  # outside w_val (model.py:1392-1400)
    )

    # MCTS value-distribution KLD, masked by availability.
    mv_mask = targets.has_mcts_value_dist.float()
    mv = targets.mcts_value_dist.float()
    mv_norm = mv / mv.sum(dim=1, keepdim=True).clamp(min=1.0)
    mcts_dist_probs = torch.softmax(outputs.mcts_dist_logits, dim=-1)
    mcts_dist_loss = mean(mv_mask * _kld(mv_norm, mcts_dist_probs))

    # --- v1 terms (model.py:1451-1566); .detach() is JAX's stop_gradient ---
    q6_err_t = (outputs.q6.detach() - targets.q6) ** 2
    q16_err_t = (outputs.q16.detach() - targets.q16) ** 2
    q50_err_t = (outputs.q50.detach() - targets.q50) ** 2
    q_err_loss = (mean(_huber(q6_err_t, outputs.q6_err))
                  + mean(_huber(q16_err_t, outputs.q16_err))
                  + mean(_huber(q50_err_t, outputs.q50_err))) / 3.0

    q_score_loss = ((mean(_huber(targets.q6_score / 10.0, outputs.q6_score / 10.0))
                     + mean(_huber(targets.q16_score / 10.0, outputs.q16_score / 10.0))
                     + mean(_huber(targets.q50_score / 10.0, outputs.q50_score / 10.0))
                     ) / 3.0).clamp(0.0, 200.0)

    q6_se_t = (outputs.q6_score.detach() - targets.q6_score) ** 2
    q16_se_t = (outputs.q16_score.detach() - targets.q16_score) ** 2
    q50_se_t = (outputs.q50_score.detach() - targets.q50_score) ** 2
    q_score_err_loss = ((mean(_huber(q6_se_t / 100.0, outputs.q6_score_err / 100.0))
                         + mean(_huber(q16_se_t / 100.0, outputs.q16_score_err / 100.0))
                         + mean(_huber(q50_se_t / 100.0, outputs.q50_score_err / 100.0))
                         ) / 3.0).clamp(0.0, 1000.0)

    # Soft policy: KLD against policy^0.25 renormalized.
    p_soft = targets.policy ** 0.25
    p_soft = p_soft / p_soft.sum(dim=-1, keepdim=True).clamp(min=eps)
    pi_soft_loss = mean(_kld(p_soft, torch.softmax(outputs.pi_logits_soft, dim=-1)))

    # Optimistic policy: weighted by sigmoid z-score of short-term surprise.
    z6 = (targets.q6 - outputs.q6.detach()) / torch.sqrt(outputs.q6_err + eps).detach()
    z16 = (targets.q16 - outputs.q16.detach()) / torch.sqrt(outputs.q16_err + eps).detach()
    z50 = (targets.q50 - outputs.q50.detach()) / torch.sqrt(outputs.q50_err + eps).detach()
    zdecay = 4.0 / 7.0
    z = (zdecay * 3 * z6 + zdecay * 1.5 * z16 + zdecay * 0.75 * z50) / 3.0
    opt_weight = torch.sigmoid((z - 1.0) * 3.0).clamp(0.0, 1.0)
    pi_opt_probs = torch.softmax(outputs.pi_logits_optimistic, dim=-1)
    pi_opt_loss = mean(opt_weight * _kld(targets.policy, pi_opt_probs))

    total = (
        w.w_pi * policy_loss
        + w.w_pi_aux * aux_dist_loss
        + w.w_pi_aux * 0.6 * aux_scalar_loss
        + val_loss
        + gamma_loss
        + w.w_mcts_dist * mcts_dist_loss
        + w.w_q_err * q_err_loss
        + w.w_q_score * q_score_loss
        + w.w_q_score_err * q_score_err_loss
        + w.w_pi_soft * pi_soft_loss
        + w.w_pi_optimistic * pi_opt_loss
    )

    return dict(
        loss=total,
        policy=policy_loss,
        policy_aux_dist=aux_dist_loss,
        policy_aux_scalar=aux_scalar_loss,
        outcome=outcome_loss,
        q6=q6_loss, q16=q16_loss, q50=q50_loss,
        score_pdf=score_pdf_loss, score_cdf=score_cdf_loss,
        own=own_loss,
        gamma=gamma_loss,
        q_err=q_err_loss, q_score=q_score_loss, q_score_err=q_score_err_loss,
        pi_soft=pi_soft_loss, pi_optimistic=pi_opt_loss,
        mcts_dist=mcts_dist_loss,
    )
