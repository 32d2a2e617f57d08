"""Serve-time folded inference forward (port of p3achygo_tpu/nn/serve.py,
the TRT-engine analogue of reference cc/nn/engine/trt_engine.cc:177-215).

* BN fold. Inference BatchNorm is a per-channel affine a*x + b. In a
  pre-activation chain `conv_i -> BN_{i+1} -> mish -> conv_{i+1}` it folds
  into the producer conv (weight scaled per output channel, bias b), so
  only `mish` stays between convolutions. A chain's head BN reads the
  residual stream and stays an explicit affine. Both run through
  `ops/preact.py` (`mish_affine`, `conv_mish`): on the card one kernel for
  the head's affine + mish and one for each in-chain bias + mish, with the
  eager ops' bits.
* Head pruning. Search reads pi, outcome, the score distribution and
  q6_err; the other heads are not computed and their `ModelOutputs` fields
  are None. With `want_optimistic` the optimistic policy head is kept too
  (JAX serve.py:206-208), for `make_eval_fn(p_opt_weight > 0)`.

Unlike the JAX version, which refolds inside every traced call, `ServeNet`
folds once at construction (in float32, then cast to the model's compute
dtype) and keeps the folded tensors. `fold_chain`, `block_plan`,
`FoldedStem` and `FoldedHeads` (JAX's shared `run_heads`) also serve the
int8-activation graph of `nn/serve_q.py`.
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
from p3achygo_tpu_torch.ops.preact import conv_mish, mish_affine

_Conv = Tuple[torch.Tensor, Optional[torch.Tensor], int]  # weight, bias, pad
_Chain = Tuple[torch.Tensor, torch.Tensor, List[_Conv]]  # head a, head b, convs


def serve_supported(config) -> bool:
    """Conv-family trunks only (classic/btl/nbt + broadcast); the
    transformer trunk serves through the plain forward (JAX serve.py:50)."""
    return not getattr(config, "is_transformer", False)


def fold_chain(cbs: Sequence[ConvBlock]) -> _Chain:
    """Fold every in-chain BN of a ConvBlock chain into its producer conv,
    in float32; the head BN stays an explicit affine (a0, b0)."""
    a0, b0 = cbs[0].BatchNorm_0.affine()
    convs: List[_Conv] = []
    for i, cb in enumerate(cbs):
        w = cb.Conv_0.weight.detach().float()
        bias = None
        if i + 1 < len(cbs):
            a_n, b_n = cbs[i + 1].BatchNorm_0.affine()
            w = w * a_n.detach()[:, None, None, None]  # scale output channels
            bias = b_n.detach().float()
        convs.append((w, bias, cb.Conv_0.padding))
    return a0.detach().float(), b0.detach().float(), convs


def block_plan(model: P3achyGoModel):
    """The trunk as ConvBlock chains, block by block, in the order both
    serving graphs walk it: ("chain", cbs) for btl and classic blocks,
    ("broadcast", ([conv_first], mix Dense, [conv_last])) and
    ("nbt", ([reduce], [res0 chain, res1 chain], [expand]))."""
    cfg = model.config
    plan = []
    for i in range(cfg.blocks):
        blk = getattr(model, block_name(cfg, i))
        if is_broadcast_block(cfg, i):
            plan.append(("broadcast", ([blk.conv_first], blk.mix.Dense_0,
                                       [blk.conv_last])))
        elif cfg.trunk_block_type == "btl":
            plan.append(("chain", [blk.reduce] + [getattr(blk, f"inner_{j}")
                                                  for j in range(blk.inner)]
                         + [blk.expand]))
        elif cfg.trunk_block_type == "classic":
            plan.append(("chain", [getattr(blk, f"conv_{j}") for j in range(blk.stack)]))
        else:
            plan.append(("nbt", ([blk.reduce],
                                 [[r.conv_0, r.conv_1] for r in (blk.nbt_res0, blk.nbt_res1)],
                                 [blk.expand])))
    return plan


class _Caster:
    """float32 -> the compute dtype, for folded tensors and Dense layers."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().float().to(self.dtype)

    def dense(self, d: Dense) -> Tuple[torch.Tensor, torch.Tensor]:
        return self(d.weight), self(d.bias)

    def chain(self, chain: _Chain) -> _Chain:
        a0, b0, convs = chain
        return self(a0), self(b0), [(self(w), None if b is None else self(b), pad)
                                    for w, b, pad in convs]


def dense_rounded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b with the product and the bias sum each rounded to x's
    dtype, as the JAX package's `_dense` rounds them (`F.linear` rounds
    once, after the bias)."""
    return x @ w.t() + b


class FoldedStem:
    """The stem (board conv + game-state Dense) in the compute dtype:
    NHWC planes + scalars -> NCHW (JAX serve.py:164-167). `linear` computes
    the Dense."""

    @torch.no_grad()
    def __init__(self, model: P3achyGoModel, linear=F.linear):
        cast = _Caster(model.dtype)
        self.dtype = model.dtype
        self.w = cast(model.init_board_conv.weight)
        self.pad = model.init_board_conv.padding
        self.game = cast.dense(model.init_game_layer)
        self.linear = linear

    @torch.no_grad()
    def __call__(self, board_state: torch.Tensor, game_state: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(board_state.to(self.dtype).permute(0, 3, 1, 2), self.w,
                     padding=self.pad)
        return x + self.linear(game_state.to(self.dtype), *self.game)[:, :, None, None]


class FoldedHeads:
    """The search-consumed heads on an NCHW trunk output in the compute
    dtype (JAX serve.py `run_heads`), shared by `ServeNet` and the int8
    graph's `nn/serve_q.py ServeQNet`. gpool's BN folds into conv_g.
    `linear` computes every Dense."""

    @torch.no_grad()
    def __init__(self, model: P3achyGoModel, want_optimistic: bool = False,
                 linear=F.linear):
        cast = _Caster(model.dtype)
        self.want_optimistic = want_optimistic
        self.linear = linear
        ph, vh = model.policy_head, model.value_head
        self.conv_p = cast(ph.conv_p.weight)
        ga, gb = ph.gpool.batch_norm_gpool.affine()
        # gpool's BN reads conv_g's output directly: fold it.
        self.conv_g = cast(ph.conv_g.weight.float() * ga[:, None, None, None])
        self.conv_g_bias = cast(gb)
        self.gpool_dense = cast.dense(ph.gpool.Dense_0)
        self.moves_w = cast(ph.output_moves.weight[0:1])
        self.pass_dense = cast.dense(ph.output_pass)
        self.opt_moves_w = cast(ph.optimistic_moves.weight)
        self.opt_pass_dense = cast.dense(ph.optimistic_pass)
        self.v_conv = cast(vh.conv.weight)
        self.q_embed = cast.dense(vh.outcome_q_embed)
        self.q_output = cast.dense(vh.outcome_q_output)
        self.gamma_pre = cast.dense(vh.gamma_pre)
        self.gamma_output = cast.dense(vh.gamma_output)
        self.score_pre_v = cast.dense(vh.score_pre_v)
        self.score_pre_s = cast(vh.score_pre_s)
        self.score_output = cast.dense(vh.score_output)
        self.scores = score_bins(model.dtype, self.conv_p.device)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> ModelOutputs:
        n = x.shape[0]
        # ---- policy head (aux/soft pruned) ----
        pco = F.conv2d(x, self.conv_p)
        g = mish(F.conv2d(x, self.conv_g, self.conv_g_bias))
        g_pooled = global_pool(g)
        pco = mish(pco + self.linear(g_pooled, *self.gpool_dense)[:, :, None, None])
        pi_board = F.conv2d(pco, self.moves_w).reshape(n, -1)
        pass_logit = self.linear(g_pooled, *self.pass_dense)[:, 0:1] - 3.0
        pi = torch.cat([pi_board, pass_logit], dim=1).float()
        pi_opt = None
        if self.want_optimistic:
            opt_board = F.conv2d(pco, self.opt_moves_w).reshape(n, -1)
            opt_pass = self.linear(g_pooled, *self.opt_pass_dense) - 3.0
            pi_opt = torch.cat([opt_board, opt_pass], dim=1).float()

        # ---- value head (ownership / mcts-dist pruned) ----
        v_pooled = global_pool(F.conv2d(x, self.v_conv))
        embed = mish(self.linear(v_pooled, *self.q_embed))
        game_outcome = self.linear(embed, *self.q_output).float()
        outcome_logits = game_outcome[:, 0:2]
        q6_err = 4.0 * torch.sigmoid(game_outcome[:, 5])
        gamma = self.linear(mish(self.linear(v_pooled, *self.gamma_pre)),
                         *self.gamma_output).float()
        u = self.linear(v_pooled, *self.score_pre_v)
        hsc = mish(u[:, None, :] + self.scores[None, :, None]
                   * self.score_pre_s[None, :, :])
        score_logits = self.linear(hsc, *self.score_output)[..., 0]
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


class ServeNet:
    """Folded, head-pruned forward of a `P3achyGoModel`."""

    @torch.no_grad()
    def __init__(self, model: P3achyGoModel, want_optimistic: bool = False):
        cast = _Caster(model.dtype)
        self.dtype = model.dtype
        self.stem = FoldedStem(model)
        self.blocks = []
        for kind, parts in block_plan(model):
            if kind == "chain":
                self.blocks.append((kind, cast.chain(fold_chain(parts))))
            elif kind == "broadcast":
                first, mix, last = parts
                self.blocks.append((kind, (cast.chain(fold_chain(first)), cast.dense(mix),
                                           cast.chain(fold_chain(last)))))
            else:
                reduce, res, expand = parts
                self.blocks.append((kind, (cast.chain(fold_chain(reduce)),
                                           [cast.chain(fold_chain(r)) for r in res],
                                           cast.chain(fold_chain(expand)))))
        self.heads = FoldedHeads(model, want_optimistic)

    @staticmethod
    def _run_chain(x: torch.Tensor, chain: _Chain) -> torch.Tensor:
        a0, b0, convs = chain
        u = mish_affine(x, a0, b0)
        for w, bias, pad in convs[:-1]:
            u = conv_mish(u, w, bias, pad)
        w, bias, pad = convs[-1]
        return F.conv2d(u, w, bias, padding=pad)

    @torch.no_grad()
    def __call__(self, board_state: torch.Tensor, game_state: torch.Tensor
                 ) -> ModelOutputs:
        return self.heads(self.trunk(self.stem(board_state, game_state)))

    @torch.no_grad()
    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The folded residual trunk on NCHW x in the compute dtype."""
        for kind, p in self.blocks:
            if kind == "chain":
                x = x + self._run_chain(x, p)
            elif kind == "broadcast":
                first, mix, last = p
                u = mish_affine(self._run_chain(x, first))
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


def serve_forward(model: P3achyGoModel, board_state: torch.Tensor,
                  game_state: torch.Tensor) -> ModelOutputs:
    """Fold `model` and run the serving forward once (tests, one-off
    calls); search folds once through `ServeNet`."""
    return ServeNet(model)(board_state, game_state)
