"""Serve-time folded inference forward (port of p3achygo_tpu/nn/serve.py,
the TRT-engine analogue of reference cc/nn/engine/trt_engine.cc:177-215).

* BN fold. Inference BatchNorm is a per-channel affine a*x + b. In a
  pre-activation chain `conv_i -> BN_{i+1} -> mish -> conv_{i+1}` it folds
  into the producer conv (weight scaled per output channel, bias b), so
  only `mish` stays between convolutions. A chain's head BN reads the
  residual stream and stays an explicit affine.
* Head pruning. Search reads pi, outcome, the score distribution and
  q6_err; the other heads are not computed and their `ModelOutputs` fields
  are None. With `want_optimistic` the optimistic policy head is kept too
  (JAX serve.py:206-208), for `make_eval_fn(p_opt_weight > 0)`.

Unlike the JAX version, which refolds inside every traced call, `ServeNet`
folds once at construction (in float32, then cast to the model's compute
dtype) and keeps the folded tensors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.models.blocks import ConvBlock, Dense, global_pool, mish
from p3achygo_tpu_torch.models.heads import score_bins
from p3achygo_tpu_torch.models.model import (
    ModelOutputs,
    P3achyGoModel,
    block_name,
    is_broadcast_block,
)

_Conv = Tuple[torch.Tensor, Optional[torch.Tensor], int]  # weight, bias, pad
_Chain = Tuple[torch.Tensor, torch.Tensor, List[_Conv]]  # head a, head b, convs


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class ServeNet:
    """Folded, head-pruned forward of a `P3achyGoModel`."""

    @torch.no_grad()
    def __init__(self, model: P3achyGoModel, want_optimistic: bool = False):
        cfg = model.config
        self.want_optimistic = want_optimistic
        self.dtype = dt = model.dtype
        cast = lambda t: t.detach().float().to(dt)
        self._cast = cast
        self.stem_w = cast(model.init_board_conv.weight)
        self.stem_pad = model.init_board_conv.padding
        self.game = self._dense(model.init_game_layer)
        self.blocks = []
        for i in range(cfg.blocks):
            blk = getattr(model, block_name(cfg, i))
            if is_broadcast_block(cfg, i):
                self.blocks.append(("broadcast", (
                    self._chain([blk.conv_first]), self._dense(blk.mix.Dense_0),
                    self._chain([blk.conv_last]))))
            elif cfg.trunk_block_type == "btl":
                cbs = [blk.reduce] + [getattr(blk, f"inner_{j}")
                                      for j in range(blk.inner)] + [blk.expand]
                self.blocks.append(("chain", self._chain(cbs)))
            elif cfg.trunk_block_type == "classic":
                cbs = [getattr(blk, f"conv_{j}") for j in range(blk.stack)]
                self.blocks.append(("chain", self._chain(cbs)))
            else:
                self.blocks.append(("nbt", (
                    self._chain([blk.reduce]),
                    [self._chain([r.conv_0, r.conv_1])
                     for r in (blk.nbt_res0, blk.nbt_res1)],
                    self._chain([blk.expand]))))

        ph, vh = model.policy_head, model.value_head
        self.conv_p = cast(ph.conv_p.weight)
        ga, gb = ph.gpool.batch_norm_gpool.affine()
        # gpool's BN reads conv_g's output directly: fold it.
        self.conv_g = cast(ph.conv_g.weight.float() * ga[:, None, None, None])
        self.conv_g_bias = cast(gb)
        self.gpool_dense = self._dense(ph.gpool.Dense_0)
        self.moves_w = cast(ph.output_moves.weight[0:1])
        self.pass_dense = self._dense(ph.output_pass)
        self.opt_moves_w = cast(ph.optimistic_moves.weight)
        self.opt_pass_dense = self._dense(ph.optimistic_pass)
        self.v_conv = cast(vh.conv.weight)
        self.q_embed = self._dense(vh.outcome_q_embed)
        self.q_output = self._dense(vh.outcome_q_output)
        self.gamma_pre = self._dense(vh.gamma_pre)
        self.gamma_output = self._dense(vh.gamma_output)
        self.score_pre_v = self._dense(vh.score_pre_v)
        self.score_pre_s = cast(vh.score_pre_s)
        self.score_output = self._dense(vh.score_output)
        self.scores = score_bins(dt, self.stem_w.device)

    def _dense(self, d: Dense) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._cast(d.weight), self._cast(d.bias)

    def _chain(self, cbs: Sequence[ConvBlock]) -> _Chain:
        """Fold every in-chain BN into its producer conv; the head BN stays
        an explicit affine."""
        a0, b0 = cbs[0].BatchNorm_0.affine()
        convs: List[_Conv] = []
        for i, cb in enumerate(cbs):
            w = cb.Conv_0.weight.float()
            bias = None
            if i + 1 < len(cbs):
                a_n, b_n = cbs[i + 1].BatchNorm_0.affine()
                w = w * a_n[:, None, None, None]  # scale output channels
                bias = self._cast(b_n)
            convs.append((self._cast(w), bias, cb.Conv_0.padding))
        return self._cast(a0), self._cast(b0), convs

    @staticmethod
    def _run_chain(x: torch.Tensor, chain: _Chain) -> torch.Tensor:
        a0, b0, convs = chain
        u = mish(x * _channel(a0) + _channel(b0))
        for i, (w, bias, pad) in enumerate(convs):
            u = F.conv2d(u, w, bias, padding=pad)
            if i + 1 < len(convs):
                u = mish(u)
        return u

    @torch.no_grad()
    def __call__(self, board_state: torch.Tensor, game_state: torch.Tensor
                 ) -> ModelOutputs:
        dt = self.dtype
        x = F.conv2d(board_state.to(dt).permute(0, 3, 1, 2), self.stem_w,
                     padding=self.stem_pad)
        x = x + F.linear(game_state.to(dt), *self.game)[:, :, None, None]
        return self._heads(self.trunk(x))

    @torch.no_grad()
    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The folded residual trunk on NCHW x in the compute dtype."""
        for kind, p in self.blocks:
            if kind == "chain":
                x = x + self._run_chain(x, p)
            elif kind == "broadcast":
                first, mix, last = p
                u = mish(self._run_chain(x, first))
                n, c, h, w = u.shape
                z = F.linear(u.reshape(n, c, h * w), *mix).reshape(n, c, h, w)
                x = x + self._run_chain(z, last)
            else:
                reduce, res, expand = p
                h_ = self._run_chain(x, reduce)
                for r in res:
                    h_ = h_ + self._run_chain(h_, r)
                x = x + self._run_chain(h_, expand)
        return x

    def _heads(self, x: torch.Tensor) -> ModelOutputs:
        n = x.shape[0]
        # ---- policy head (aux/soft pruned) ----
        pco = F.conv2d(x, self.conv_p)
        g = mish(F.conv2d(x, self.conv_g, self.conv_g_bias))
        g_pooled = global_pool(g)
        pco = mish(pco + F.linear(g_pooled, *self.gpool_dense)[:, :, None, None])
        pi_board = F.conv2d(pco, self.moves_w).reshape(n, -1)
        pass_logit = F.linear(g_pooled, *self.pass_dense)[:, 0:1] - 3.0
        pi = torch.cat([pi_board, pass_logit], dim=1).float()
        pi_opt = None
        if self.want_optimistic:
            opt_board = F.conv2d(pco, self.opt_moves_w).reshape(n, -1)
            opt_pass = F.linear(g_pooled, *self.opt_pass_dense) - 3.0
            pi_opt = torch.cat([opt_board, opt_pass], dim=1).float()

        # ---- value head (ownership / mcts-dist pruned) ----
        v_pooled = global_pool(F.conv2d(x, self.v_conv))
        embed = mish(F.linear(v_pooled, *self.q_embed))
        game_outcome = F.linear(embed, *self.q_output).float()
        outcome_logits = game_outcome[:, 0:2]
        q6_err = 4.0 * torch.sigmoid(game_outcome[:, 5])
        gamma = F.linear(mish(F.linear(v_pooled, *self.gamma_pre)),
                         *self.gamma_output).float()
        u = F.linear(v_pooled, *self.score_pre_v)
        hsc = mish(u[:, None, :] + self.scores[None, :, None]
                   * self.score_pre_s[None, :, :])
        score_logits = F.linear(hsc, *self.score_output)[..., 0]
        score_logits = (torch.clamp(F.softplus(gamma), max=10.0)
                        * score_logits.float())
        return ModelOutputs(
            pi_logits=pi, pi_probs=None,
            outcome_logits=outcome_logits,
            outcome_probs=torch.softmax(outcome_logits, dim=-1),
            ownership=None,
            score_logits=score_logits,
            score_probs=torch.softmax(score_logits, dim=-1),
            gamma=gamma, pi_logits_aux=None,
            q6=None, q16=None, q50=None,
            q6_err=q6_err, q16_err=None, q50_err=None,
            q6_score=None, q16_score=None, q50_score=None,
            q6_score_err=None, q16_score_err=None, q50_score_err=None,
            pi_logits_soft=None, pi_logits_optimistic=pi_opt,
            mcts_dist_logits=None, mcts_dist_probs=None,
        )


def serve_forward(model: P3achyGoModel, board_state: torch.Tensor,
                  game_state: torch.Tensor) -> ModelOutputs:
    """Fold `model` and run the serving forward once (tests, one-off
    calls); search folds once through `ServeNet`."""
    return ServeNet(model)(board_state, game_state)
