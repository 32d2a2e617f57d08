"""P3achyGo network (port of p3achygo_tpu/models/model.py; reference
python/model.py P3achyGoModel :1063-1295): 15-plane board input + 8 game
scalars, init conv (conv_size+2) + game-state bias, a trunk of
classic/btl/nbt blocks with a broadcast block every `broadcast_interval`
(or, for a transformer config, an `embed` Dense, a positional embedding
and transformer blocks over the 361 points, models/transformer.py), then
policy and value heads. `forward(..., train=True)` is the training
forward: BatchNorm from batch statistics (running statistics updated in
place, models/blocks.py) and gradients recorded; otherwise BatchNorm reads
the running statistics and no graph is built.

The public boundary keeps the JAX layout: planes NHWC [N, 19, 19, 15];
the network runs NCHW inside. All 25 outputs are float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from p3achygo_tpu_torch.constants import (
    NUM_INPUT_FEATURES,
    NUM_INPUT_PLANES,
    NUM_LOCS,
)
from p3achygo_tpu_torch.models.blocks import (
    BatchNorm,
    BottleneckResidualBlock,
    BroadcastResidualBlock,
    ClassicResidualBlock,
    Conv,
    Dense,
    NbtResidualBlock,
)
from p3achygo_tpu_torch.models.config import ModelConfig
from p3achygo_tpu_torch.models.heads import PolicyHead, ValueHead
from p3achygo_tpu_torch.models.transformer import (
    POS_EMBED_STD,
    FlaxDense,
    LayerNorm,
    PositionalEmbedding,
    Projection,
    TransformerBlock,
)


class ModelOutputs(NamedTuple):
    """All model outputs, float32 (model.py docstring outputs 0-24). The
    serving forward leaves the fields search does not read as None."""

    pi_logits: Optional[torch.Tensor]  # [N, 362]
    pi_probs: Optional[torch.Tensor]
    outcome_logits: Optional[torch.Tensor]  # [N, 2]
    outcome_probs: Optional[torch.Tensor]
    ownership: Optional[torch.Tensor]  # [N, 361]
    score_logits: Optional[torch.Tensor]  # [N, 800]
    score_probs: Optional[torch.Tensor]
    gamma: Optional[torch.Tensor]  # [N, 1]
    pi_logits_aux: Optional[torch.Tensor]  # [N, 362]
    q6: Optional[torch.Tensor]  # [N]
    q16: Optional[torch.Tensor]
    q50: Optional[torch.Tensor]
    q6_err: Optional[torch.Tensor]
    q16_err: Optional[torch.Tensor]
    q50_err: Optional[torch.Tensor]
    q6_score: Optional[torch.Tensor]
    q16_score: Optional[torch.Tensor]
    q50_score: Optional[torch.Tensor]
    q6_score_err: Optional[torch.Tensor]
    q16_score_err: Optional[torch.Tensor]
    q50_score_err: Optional[torch.Tensor]
    pi_logits_soft: Optional[torch.Tensor]  # [N, 362]
    pi_logits_optimistic: Optional[torch.Tensor]  # [N, 362]
    mcts_dist_logits: Optional[torch.Tensor]  # [N, 51]
    mcts_dist_probs: Optional[torch.Tensor]


def is_broadcast_block(cfg: ModelConfig, i: int) -> bool:
    return i % cfg.broadcast_interval == cfg.broadcast_interval - 1


def block_name(cfg: ModelConfig, i: int) -> str:
    """The flax module name of trunk block i."""
    if cfg.is_transformer:
        return f"transformer_{i}"
    if is_broadcast_block(cfg, i):
        return f"broadcast_res_{i}"
    prefix = {"btl": "bottleneck_res", "classic": "classic_res",
              "nbt": "nbt_res"}.get(cfg.trunk_block_type)
    if prefix is None:
        raise ValueError(cfg.trunk_block_type)
    return f"{prefix}_{i}"


class P3achyGoModel(nn.Module):
    """Parameters are float32; `dtype` is the compute dtype (bf16 to serve)."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        cfg = config
        C = cfg.channels
        self.init_board_conv = Conv(NUM_INPUT_PLANES, C, cfg.conv_size + 2)
        self.init_game_layer = Dense(NUM_INPUT_FEATURES, C)
        if cfg.is_transformer:
            # The heads read the embedding width (JAX model.py:90-96).
            self.embed = FlaxDense(C, cfg.embed_dim)
            self.pos_embed = PositionalEmbedding(cfg.embed_dim)
            C = cfg.embed_dim
        for i in range(cfg.blocks):
            name = block_name(cfg, i)
            if cfg.is_transformer:
                blk = TransformerBlock(C, cfg.embed_dim, cfg.num_heads)
            elif is_broadcast_block(cfg, i):
                blk = BroadcastResidualBlock(C, NUM_LOCS)
            elif cfg.trunk_block_type == "btl":
                blk = BottleneckResidualBlock(C, cfg.bottleneck_channels,
                                              cfg.conv_size, cfg.bottleneck_length)
            elif cfg.trunk_block_type == "classic":
                blk = ClassicResidualBlock(C, cfg.conv_size)
            else:
                blk = NbtResidualBlock(C, cfg.bottleneck_channels, cfg.conv_size)
            self.add_module(name, blk)
        self.policy_head = PolicyHead(C, cfg.head_channels)
        self.value_head = ValueHead(C, cfg.head_channels, cfg.c_val)

    def stem(self, board_state: torch.Tensor, game_state: torch.Tensor
             ) -> torch.Tensor:
        """NHWC planes + scalars -> NCHW trunk input in the compute dtype."""
        x = board_state.to(self.dtype).permute(0, 3, 1, 2)
        x = self.init_board_conv(x)
        return x + self.init_game_layer(game_state.to(self.dtype))[:, :, None, None]

    def forward(self, board_state: torch.Tensor, game_state: torch.Tensor,
                trunk_fn=None, train: bool = False) -> ModelOutputs:
        """`trunk_fn` (NHWC [N, 19, 19, C] -> same, e.g.
        nn/trunk_kernel.py `build_trunk_fn`) replaces the residual trunk; the
        stem and all heads stay this module (JAX model.py:72, 88-89). It is
        inference only. `train=True` records gradients unless the caller
        disabled them (a BN refresh runs it under `torch.no_grad()`)."""
        if train and trunk_fn is not None:
            raise ValueError("trunk_fn is an inference-only trunk")
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            return self._forward(board_state, game_state, trunk_fn, train)

    def transformer_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW stem output -> embed, positional embedding and the
        transformer blocks over tokens h * 19 + w -> NCHW [N, E, 19, 19]."""
        n, _, h, w = x.shape
        t = self.pos_embed(self.embed(x.flatten(2).transpose(1, 2)))
        for i in range(self.config.blocks):
            t = getattr(self, block_name(self.config, i))(t)
        return t.transpose(1, 2).reshape(n, -1, h, w)

    def _forward(self, board_state, game_state, trunk_fn, train) -> ModelOutputs:
        x = self.stem(board_state, game_state)
        if trunk_fn is not None:
            x = trunk_fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = x.to(self.dtype).contiguous()
        elif self.config.is_transformer:
            x = self.transformer_trunk(x)
        else:
            for i in range(self.config.blocks):
                x = getattr(self, block_name(self.config, i))(x, train)
        pi, pi_aux, pi_soft, pi_opt = (t.float() for t in self.policy_head(x, train))
        vh = self.value_head(x)
        return ModelOutputs(
            pi_logits=pi,
            pi_probs=torch.softmax(pi, dim=-1),
            outcome_logits=vh["outcome_logits"],
            outcome_probs=torch.softmax(vh["outcome_logits"], dim=-1),
            ownership=vh["ownership"],
            score_logits=vh["score_logits"],
            score_probs=torch.softmax(vh["score_logits"], dim=-1),
            gamma=vh["gamma"],
            pi_logits_aux=pi_aux,
            q6=vh["q6"], q16=vh["q16"], q50=vh["q50"],
            q6_err=vh["q6_err"], q16_err=vh["q16_err"], q50_err=vh["q50_err"],
            q6_score=vh["q6_score"], q16_score=vh["q16_score"],
            q50_score=vh["q50_score"],
            q6_score_err=vh["q6_score_err"], q16_score_err=vh["q16_score_err"],
            q50_score_err=vh["q50_score_err"],
            pi_logits_soft=pi_soft,
            pi_logits_optimistic=pi_opt,
            mcts_dist_logits=vh["mcts_dist_logits"],
            mcts_dist_probs=torch.softmax(vh["mcts_dist_logits"], dim=-1),
        )


def build_model(config: ModelConfig, dtype: torch.dtype = torch.float32,
                device="cuda") -> P3achyGoModel:
    return P3achyGoModel(config, dtype).to(device).eval()


@torch.no_grad()
def init_params(model: P3achyGoModel, generator: torch.Generator) -> None:
    """Random weights from `generator` (a CPU generator), in place:
    lecun-normal conv, dense and attention kernels (std 1/sqrt(fan_in)),
    zero biases, identity BatchNorm and LayerNorm, a normal(0.02)
    positional embedding, zero `gamma_output` kernel — flax's initializers
    without the truncation."""
    randn = lambda t: torch.randn(t.shape, generator=generator)
    for name, mod in model.named_modules():
        if isinstance(mod, (Conv, Dense, Projection)):
            w = mod.weight
            fan_in = mod.fan_in if isinstance(mod, Projection) else w[0].numel()
            w.copy_((randn(w) / fan_in ** 0.5).to(w.device))
            if not isinstance(mod, Conv):
                mod.bias.zero_()
        elif isinstance(mod, PositionalEmbedding):
            mod.pos_embed.copy_((randn(mod.pos_embed) * POS_EMBED_STD).to(
                mod.pos_embed.device))
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    vh = model.value_head
    vh.gamma_output.weight.zero_()
    vh.score_pre_s.copy_(torch.randn(vh.score_pre_s.shape,
                                     generator=generator).to(vh.score_pre_s.device))
