"""Trunk building blocks (port of p3achygo_tpu/models/blocks.py; reference
python/model.py:203-724), NCHW inside.

Module and attribute names follow the flax parameter tree (`Conv_0`,
`BatchNorm_0`, `Dense_0`, `reduce`, `inner_0`, ...) so `bridge.py` maps
flax variables onto them by path. Parameters stay float32; each layer
casts its weights to the activation dtype on use (flax's `dtype` rule).
BatchNorm runs as inference only, from running statistics, eps 1e-3.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def mish(x: torch.Tensor) -> torch.Tensor:
    """mish(x) = x * tanh(softplus(x)) as one rational in u = e^x:
    tanh(log(1 + u)) = (u^2 + 2u) / (u^2 + 2u + 2). The exponent input is
    clamped at 20 (exact: mish(x) rounds to x there). Same formula as the
    JAX package's blocks.py:20 and trunk_kernel.py:55-60."""
    u = torch.exp(torch.clamp(x, max=20.0))
    n = u * u + 2.0 * u
    return x * n / (n + 2.0)


class BatchNorm(nn.Module):
    """Inference BatchNorm over channel axis 1: a*x + b per channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b) in float32 with BN(x) == a*x + b."""
        a = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return a, self.bias - self.running_mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.affine()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


class Conv(nn.Module):
    """Bias-free 'SAME' 2D convolution, OIHW weight."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.padding = kernel // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), padding=self.padding)


class Dense(nn.Module):
    """Linear layer over the last axis, [out, in] weight."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvBlock(nn.Module):
    """Pre-activation conv: BN -> mish -> conv (model.py:287-296)."""

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_0 = Conv(cin, features, kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(mish(self.BatchNorm_0(x)))


class ClassicResidualBlock(nn.Module):
    """x + conv(conv(x)) (model.py:330-371)."""

    def __init__(self, features: int, conv_size: int, stack_size: int = 2):
        super().__init__()
        self.stack = stack_size
        for i in range(stack_size):
            setattr(self, f"conv_{i}", ConvBlock(features, features, conv_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for i in range(self.stack):
            x = getattr(self, f"conv_{i}")(x)
        return res + x


class BottleneckResidualBlock(nn.Module):
    """1x1 reduce -> (stack_size-2) KxK convs -> 1x1 expand, residual
    (model.py:372-430)."""

    def __init__(self, features: int, bottleneck: int, conv_size: int,
                 stack_size: int = 3):
        super().__init__()
        self.inner = stack_size - 2
        self.reduce = ConvBlock(features, bottleneck, 1)
        for i in range(self.inner):
            setattr(self, f"inner_{i}", ConvBlock(bottleneck, bottleneck, conv_size))
        self.expand = ConvBlock(bottleneck, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        x = self.reduce(x)
        for i in range(self.inner):
            x = getattr(self, f"inner_{i}")(x)
        return res + self.expand(x)


class NbtResidualBlock(nn.Module):
    """1x1 reduce -> 2 classic blocks at bottleneck width -> 1x1 expand,
    residual (model.py:431-489)."""

    def __init__(self, features: int, bottleneck: int, conv_size: int):
        super().__init__()
        self.reduce = ConvBlock(features, bottleneck, 1)
        self.nbt_res0 = ClassicResidualBlock(bottleneck, conv_size)
        self.nbt_res1 = ClassicResidualBlock(bottleneck, conv_size)
        self.expand = ConvBlock(bottleneck, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.nbt_res1(self.nbt_res0(self.reduce(x)))
        return x + self.expand(h)


class Broadcast(nn.Module):
    """Per-channel global mix: Dense over the 361 positions
    (model.py:509-581)."""

    def __init__(self, positions: int):
        super().__init__()
        self.Dense_0 = Dense(positions, positions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.Dense_0(mish(x).reshape(n, c, h * w))
        return y.reshape(n, c, h, w)


class BroadcastResidualBlock(nn.Module):
    """1x1 conv -> broadcast mix -> 1x1 conv, residual (model.py:583-625)."""

    def __init__(self, features: int, positions: int):
        super().__init__()
        self.conv_first = ConvBlock(features, features, 1)
        self.mix = Broadcast(positions)
        self.conv_last = ConvBlock(features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_last(self.mix(self.conv_first(x)))


def global_pool(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, 2C]: concat(mean, max) per channel
    (model.py:634-652)."""
    return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)


class GlobalPoolBias(nn.Module):
    """x + dense(gpool(mish(BN(g)))) channelwise; returns (x, g_pooled)
    (model.py:655-724)."""

    def __init__(self, channels: int):
        super().__init__()
        self.batch_norm_gpool = BatchNorm(channels)
        self.Dense_0 = Dense(2 * channels, channels)

    def forward(self, x: torch.Tensor, g: torch.Tensor):
        g_pooled = global_pool(mish(self.batch_norm_gpool(g)))
        return x + self.Dense_0(g_pooled)[:, :, None, None], g_pooled
