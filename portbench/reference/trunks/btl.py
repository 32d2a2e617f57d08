"""The bottleneck ("btl") trunk of p3achygo (python/model.py: the
bottleneck and broadcast residual blocks), in plain float32 torch, as a
trunk module of `reference/network.py`.

Block i is a broadcast block when i % broadcast_interval is
broadcast_interval - 1: a 1x1 conv block, mish, a Dense over the 361
points of each channel and a 1x1 conv block, added to x. Every other
block is a bottleneck: a 1x1 conv block C -> Cb, `inner_bottleneck_layers`
KxK conv blocks at Cb and a 1x1 conv block Cb -> C, added to x. A conv
block is BatchNorm, mish, then a bias-free 'SAME' conv. The other conv
trunks (classic, nbt) share the broadcast block: `broadcast_shapes` and
`broadcast_block` are theirs to import.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from portbench.harness.work import broadcast_work, segment_work
from portbench.reference import network
from portbench.reference.network import BOARD, POINTS, conv_block_shapes, dense_shapes, mish

# BatchNorm statistics uniform, kernels over their [out, in, ...] fan-in.
draw_rule = network.draw_rule


def is_broadcast(cfg: dict, i: int) -> bool:
    return i % cfg["broadcast_interval"] == cfg["broadcast_interval"] - 1


def broadcast_shapes(out, prefix: str, C: int) -> None:
    conv_block_shapes(out, f"{prefix}.conv_first", C, C, 1)
    dense_shapes(out, f"{prefix}.mix.Dense_0", POINTS, POINTS)
    conv_block_shapes(out, f"{prefix}.conv_last", C, C, 1)


def broadcast_block(net, prefix: str, x: torch.Tensor) -> torch.Tensor:
    y = net._conv_block(f"{prefix}.conv_first", x)
    n, c = y.shape[:2]
    y = net._dense(f"{prefix}.mix.Dense_0", mish(y).reshape(n, c, POINTS))
    return x + net._conv_block(f"{prefix}.conv_last", y.reshape(n, c, BOARD, BOARD))


def parameter_shapes(cfg: dict):
    C, cb, k = cfg["channels"], cfg["bottleneck_channels"], cfg["conv_size"]
    out = OrderedDict()
    for i in range(cfg["blocks"]):
        if is_broadcast(cfg, i):
            broadcast_shapes(out, f"broadcast_res_{i}", C)
            continue
        p = f"bottleneck_res_{i}"
        conv_block_shapes(out, f"{p}.reduce", C, cb, 1)
        for j in range(cfg["inner_bottleneck_layers"]):
            conv_block_shapes(out, f"{p}.inner_{j}", cb, cb, k)
        conv_block_shapes(out, f"{p}.expand", cb, C, 1)
    return out


def forward(net, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    for i in range(cfg["blocks"]):
        if is_broadcast(cfg, i):
            x = broadcast_block(net, f"broadcast_res_{i}", x)
            continue
        p = f"bottleneck_res_{i}"
        y = net._conv_block(f"{p}.reduce", x)
        for j in range(cfg["inner_bottleneck_layers"]):
            y = net._conv_block(f"{p}.inner_{j}", y)
        x = x + net._conv_block(f"{p}.expand", y)
    return x


def flops(cfg: dict) -> int:
    """A bottleneck block as one block of a segment call, a broadcast block
    as one broadcast call (`harness.work`), on one board."""
    C, cb = cfg["channels"], cfg["bottleneck_channels"]
    layers = cfg["inner_bottleneck_layers"] + 2
    return sum(broadcast_work(1, C)[0] if is_broadcast(cfg, i)
               else segment_work(1, 1, layers, C, cb)[0] for i in range(cfg["blocks"]))


def head_width(cfg: dict) -> int:
    return cfg["channels"]
