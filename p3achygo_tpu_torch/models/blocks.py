"""Trunk building blocks (port of p3achygo_tpu/models/blocks.py; reference
python/model.py:203-724), NCHW inside.

Module and attribute names follow the flax parameter tree (`Conv_0`,
`BatchNorm_0`, `Dense_0`, `reduce`, `inner_0`, ...) so `bridge.py` maps
flax variables onto them by path. Parameters stay float32; each layer
casts its weights to the activation dtype on use (flax's `dtype` rule).

BatchNorm (eps 1e-3) runs from its running statistics, or with
`train=True` from the batch's, as flax's BatchNorm does under
`mutable=["batch_stats"]` (flax 0.12 `_compute_stats` / `_normalize`):
statistics in float32 whatever the compute dtype, the variance as
E[x^2] - E[x]^2 clipped at 0, and the running statistics updated in place
to 0.99 * running + 0.01 * batch, the variance term being that biased batch
variance. `torch.nn.BatchNorm2d` differs on the last two points, hence the
functional form here. Under data parallelism (`BatchNorm.group`) the batch
mean and E[x^2] are averaged over the data-parallel ranks first, as XLA's
SPMD takes them over the global batch.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from p3achygo_tpu_torch.ops.preact import mish, mish_affine

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


def mish_f32(x: torch.Tensor) -> torch.Tensor:
    """mish as the fused trunk computes it (the JAX package's
    nn/trunk_kernel.py:55-60 `_mish_f32`): two rationals in t = e^-|x|,
    x * (1 + 2t) / (1 + 2t + 2t^2) for x >= 0 and
    x * (t^2 + 2t) / (t^2 + 2t + 2) below. Equal to `mish` in exact
    arithmetic; the two differ in the last float32 bits."""
    t = torch.exp(-torch.abs(x))
    pos = (1.0 + 2.0 * t) / (1.0 + 2.0 * t + 2.0 * t * t)
    neg = (t * t + 2.0 * t) / (t * t + 2.0 * t + 2.0)
    return x * torch.where(x >= 0, pos, neg)


def group_mean(t: torch.Tensor, group) -> torch.Tensor:
    """Mean of `t` over the ranks of a torch.distributed `group`, with the
    gradient all-reduced back (torch.distributed.nn's autograd-aware
    all_reduce), so a loss computed from it differentiates through every
    rank's share."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group) / torch.distributed.get_world_size(group)


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1: a*x + b per channel from the running
    statistics, or normalised by the batch statistics with `train=True`
    (which also updates the running statistics). `group`, set by a
    data-parallel train step for its duration, is the process group whose
    ranks' batches make up the batch (None: this process's batch)."""

    group = None

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not train:
            a, b = self.affine()
            return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        mean, mean_sq = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
        if self.group is not None:
            mean, mean_sq = group_mean(torch.stack([mean, mean_sq]), self.group)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1.0 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1.0 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


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
    """Pre-activation conv: BN -> mish -> conv (model.py:287-296). At
    inference BN's affine and mish are one `ops.preact.mish_affine` call."""

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(cin)
        self.Conv_0 = Conv(cin, features, kernel)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            return self.Conv_0(mish(self.BatchNorm_0(x, train)))
        return self.Conv_0(mish_affine(x, *self.BatchNorm_0.affine()))


class ClassicResidualBlock(nn.Module):
    """x + conv(conv(x)) (model.py:330-371)."""

    def __init__(self, features: int, conv_size: int, stack_size: int = 2):
        super().__init__()
        self.stack = stack_size
        for i in range(stack_size):
            setattr(self, f"conv_{i}", ConvBlock(features, features, conv_size))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        res = x
        for i in range(self.stack):
            x = getattr(self, f"conv_{i}")(x, train)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        res = x
        x = self.reduce(x, train)
        for i in range(self.inner):
            x = getattr(self, f"inner_{i}")(x, train)
        return res + self.expand(x, train)


class NbtResidualBlock(nn.Module):
    """1x1 reduce -> 2 classic blocks at bottleneck width -> 1x1 expand,
    residual (model.py:431-489)."""

    def __init__(self, features: int, bottleneck: int, conv_size: int):
        super().__init__()
        self.reduce = ConvBlock(features, bottleneck, 1)
        self.nbt_res0 = ClassicResidualBlock(bottleneck, conv_size)
        self.nbt_res1 = ClassicResidualBlock(bottleneck, conv_size)
        self.expand = ConvBlock(bottleneck, features, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.nbt_res1(self.nbt_res0(self.reduce(x, train), train), train)
        return x + self.expand(h, train)


class Broadcast(nn.Module):
    """Per-channel global mix: Dense over the 361 positions
    (model.py:509-581)."""

    def __init__(self, positions: int):
        super().__init__()
        self.Dense_0 = Dense(positions, positions)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.Dense_0((mish(x) if train else mish_affine(x)).reshape(n, c, h * w))
        return y.reshape(n, c, h, w)


class BroadcastResidualBlock(nn.Module):
    """1x1 conv -> broadcast mix -> 1x1 conv, residual (model.py:583-625)."""

    def __init__(self, features: int, positions: int):
        super().__init__()
        self.conv_first = ConvBlock(features, features, 1)
        self.mix = Broadcast(positions)
        self.conv_last = ConvBlock(features, features, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x + self.conv_last(self.mix(self.conv_first(x, train), train), train)


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

    def forward(self, x: torch.Tensor, g: torch.Tensor, train: bool = False):
        g_pooled = global_pool(mish(self.batch_norm_gpool(g, train)))
        return x + self.Dense_0(g_pooled)[:, :, None, None], g_pooled
