"""Transformer trunk (port of p3achygo_tpu/models/transformer.py; reference
python/model_transformer.py): the 361 board points as tokens with a learned
2D positional embedding, then pre-LN self-attention + MLP blocks.

Tokens are [N, 361, C] in the row-major order h * 19 + w of the JAX
package's NHWC reshape (from NCHW: `x.flatten(2).transpose(1, 2)`).

Every layer follows what flax 0.12 computes, not torch's defaults:

- LayerNorm: eps 1e-6; mean and variance in float32 with the variance as
  max(0, E[x^2] - E[x]^2) (flax's `use_fast_variance`); the output cast to
  the compute dtype (`_compute_stats` / `_normalize`).
- Dense and the attention projections (flax `Dense` / `DenseGeneral`): a
  product in the compute dtype, then the bias added in the compute dtype,
  two rounding points (torch's `F.linear` may fuse the bias into one).
- MultiHeadDotProductAttention (`dot_product_attention`): q, k, v and out
  each with a bias; the query divided by sqrt(head_dim) cast to the
  compute dtype before q.k^T; the softmax in the compute dtype
  (`force_fp32_for_softmax=False`), as jax.nn.softmax writes it:
  exp(x - max), then divided by its sum; no dropout.
- gelu: the tanh approximation (flax `nn.gelu`, approximate=True).

The attention's core (q.k^T, the softmax and weights.v; not the four
projections) runs inside the tracer's span `trunk.attention` (rows,
tokens, heads, head_dim), one a block, a flag test when the tracer is off.

The attention is plain PyTorch on purpose: the JAX package computes it
with XLA einsums, not a Pallas kernel, and `scaled_dot_product_attention`
rounds bf16 at other points.

Kernel layouts: the attention projections keep flax's own layout
(query/key/value [C, H, D], out [H, D, C]) and the positional embedding
flax's [19, 19, C]; the Dense layers store [out, in] as models/blocks.py's
`Dense` does. `bridge.py` maps both.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from p3achygo_tpu_torch import tracing
from p3achygo_tpu_torch.constants import BOARD_LEN
from p3achygo_tpu_torch.models.blocks import Dense

LN_EPS = 1e-6
POS_EMBED_STD = 0.02


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (scale and bias float32)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class FlaxDense(Dense):
    """`Dense` with flax's two rounding points: x @ W, then + b."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.to(x.dtype).t()) + self.bias.to(x.dtype)


class Projection(nn.Module):
    """flax DenseGeneral with the kernel in flax's layout `in_shape +
    out_shape` and a bias of `out_shape`: the input's trailing
    len(in_shape) axes are contracted."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.zeros(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    @property
    def fan_in(self) -> int:
        return math.prod(self.in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        w = self.weight.to(x.dtype).reshape(self.fan_in, -1)
        y = torch.matmul(x.reshape(*lead, self.fan_in), w)
        y = y + self.bias.to(x.dtype).reshape(-1)
        return y.reshape(*lead, *self.out_shape)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis at its rounding points in x's
    dtype: e = exp(x - max) rounded, its sum (float32 accumulation)
    rounded, then e / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention over tokens [N, T, C] -> [N, T, C]."""

    def __init__(self, features: int, num_heads: int, qkv_features: int):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} not divisible by "
                             f"num_heads {num_heads}")
        heads = (num_heads, qkv_features // num_heads)
        self.query = Projection((features,), heads)
        self.key = Projection((features,), heads)
        self.value = Projection((features,), heads)
        self.out = Projection(heads, (features,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # [N, T, H, D] -> [N, H, T, D]
        q, k, v = (p(x).transpose(1, 2) for p in (self.query, self.key, self.value))
        n, heads, tokens, head_dim = q.shape
        depth = torch.tensor(math.sqrt(head_dim), dtype=x.dtype, device=x.device)
        # The core alone: what a fused attention kernel would replace.
        with tracing.span("trunk.attention", rows=n, tokens=tokens, heads=heads,
                          head_dim=head_dim):
            weights = softmax(torch.matmul(q / depth, k.transpose(-1, -2)))
            y = torch.matmul(weights, v)
        return self.out(y.transpose(1, 2))


class TransformerBlock(nn.Module):
    """Pre-LN block (JAX transformer.py:18-39): t + attn(LN(t)), then
    t + Dense(gelu(Dense(LN(t)))) with an MLP of mlp_ratio * C. Takes and
    returns tokens [N, T, C]."""

    def __init__(self, features: int, embed_dim: int, num_heads: int,
                 mlp_ratio: int = 4):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(features)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            features, num_heads, embed_dim)
        self.LayerNorm_1 = LayerNorm(features)
        self.Dense_0 = FlaxDense(features, mlp_ratio * features)
        self.Dense_1 = FlaxDense(mlp_ratio * features, features)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(t))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(t)), approximate="tanh")
        return t + self.Dense_1(y)


class PositionalEmbedding(nn.Module):
    """Learned additive 2D embedding, [19, 19, C] as in flax."""

    def __init__(self, features: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(BOARD_LEN, BOARD_LEN, features))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return t + self.pos_embed.reshape(-1, self.pos_embed.shape[-1]).to(t.dtype)
