"""Policy and value heads (port of p3achygo_tpu/models/heads.py; reference
python/model.py PolicyHead :725-823, ValueHead :824-990)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from p3achygo_tpu_torch.constants import NUM_LOCS, NUM_SCORE_LOGITS, NUM_V_BUCKETS
from p3achygo_tpu_torch.models.blocks import Conv, Dense, GlobalPoolBias, global_pool, mish


def score_bins(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Score-bin centres the score head conditions on: 0.05*i + 0.025."""
    half = NUM_SCORE_LOGITS // 2
    return (0.05 * torch.arange(-half, half, dtype=torch.float32, device=device)
            + 0.025).to(dtype)


class PolicyHead(nn.Module):
    """-> (pi, pi_aux, pi_soft, pi_optimistic) logits, each [N, 362]."""

    def __init__(self, cin: int, channels: int):
        super().__init__()
        self.conv_p = Conv(cin, channels, 1)
        self.conv_g = Conv(cin, channels, 1)
        self.gpool = GlobalPoolBias(channels)
        self.output_moves = Conv(channels, 2, 1)
        self.output_pass = Dense(2 * channels, 2)
        self.soft_moves = Conv(channels, 1, 1)
        self.soft_pass = Dense(2 * channels, 1)
        self.optimistic_moves = Conv(channels, 1, 1)
        self.optimistic_pass = Dense(2 * channels, 1)

    def forward(self, x: torch.Tensor, train: bool = False):
        n = x.shape[0]
        p, g_pooled = self.gpool(self.conv_p(x), self.conv_g(x), train)
        p = mish(p)
        pi_both = self.output_moves(p).reshape(n, 2, NUM_LOCS)
        # Pass logits biased down by 3 (model.py:800-802).
        pass_logits = self.output_pass(g_pooled) - 3.0
        pi = torch.cat([pi_both[:, 0], pass_logits[:, 0:1]], dim=1)
        pi_aux = torch.cat([pi_both[:, 1], pass_logits[:, 1:2]], dim=1)
        pi_soft = torch.cat([self.soft_moves(p).reshape(n, -1),
                             self.soft_pass(g_pooled) - 3.0], dim=1)
        pi_opt = torch.cat([self.optimistic_moves(p).reshape(n, -1),
                            self.optimistic_pass(g_pooled) - 3.0], dim=1)
        return pi, pi_aux, pi_soft, pi_opt


class ValueHead(nn.Module):
    """-> dict of value-family outputs (model.py:824-990). The score head's
    Dense over concat([v_pooled, score_bin]) is split into a shared term
    and a per-bin scalar term, as in the JAX package."""

    def __init__(self, cin: int, channels: int, c_val: int):
        super().__init__()
        self.conv = Conv(cin, channels, 1)
        self.outcome_q_embed = Dense(2 * channels, c_val)
        self.outcome_q_output = Dense(c_val, 14)
        self.outcome_mcts_dist = Dense(c_val, NUM_V_BUCKETS)
        self.conv_ownership = Conv(channels, 1, 1)
        self.gamma_pre = Dense(2 * channels, c_val)
        self.gamma_output = Dense(c_val, 1)
        self.score_pre_v = Dense(2 * channels, c_val)
        self.score_pre_s = nn.Parameter(torch.zeros(1, c_val))
        self.score_output = Dense(c_val, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = x.shape[0]
        dtype = x.dtype
        v = self.conv(x)
        v_pooled = global_pool(v)
        embed = mish(self.outcome_q_embed(v_pooled))
        go = self.outcome_q_output(embed).float()
        mcts_dist_logits = self.outcome_mcts_dist(embed).float()
        ownership = torch.tanh(self.conv_ownership(v)).reshape(n, -1)
        gamma = self.gamma_output(mish(self.gamma_pre(v_pooled))).float()

        u = self.score_pre_v(v_pooled)  # [N, c_val]
        w_s = self.score_pre_s.to(dtype)
        h = mish(u[:, None, :] + score_bins(dtype, x.device)[None, :, None]
                 * w_s[None, :, :])  # [N, 800, c_val]
        score_logits = self.score_output(h)[..., 0]
        score_logits = (torch.clamp(F.softplus(gamma), max=10.0)
                        * score_logits.float())
        return dict(
            outcome_logits=go[:, 0:2],
            ownership=ownership.float(),
            score_logits=score_logits,
            gamma=gamma,
            q6=torch.tanh(go[:, 2]), q16=torch.tanh(go[:, 3]),
            q50=torch.tanh(go[:, 4]),
            q6_err=4.0 * torch.sigmoid(go[:, 5]),
            q16_err=4.0 * torch.sigmoid(go[:, 6]),
            q50_err=4.0 * torch.sigmoid(go[:, 7]),
            q6_score=go[:, 8], q16_score=go[:, 9], q50_score=go[:, 10],
            q6_score_err=go[:, 11].abs(), q16_score_err=go[:, 12].abs(),
            q50_score_err=go[:, 13].abs(),
            mcts_dist_logits=mcts_dist_logits,
        )
