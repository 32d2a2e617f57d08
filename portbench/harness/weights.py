"""Seeded network weights, made on the device in a few large calls.

Every parameter of `reference.network.parameter_shapes` comes from one
normal and one uniform draw of a `torch.Generator` on the device seeded
from the run's seed: kernels normal over the square root of their fan-in,
Dense biases and the score head's per-bin term normal times 0.1, and the
BatchNorm statistics perturbed so that no fold is an identity (scale in
[0.7, 1.3), shift and mean in [-0.1, 0.1), variance in [0.5, 1.5)). The
parameters are float32, the type the model stores and serves them in (it
computes in bf16). The same dict goes to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.network import parameter_shapes

BN_STATS = ("weight", "bias", "running_mean", "running_var")


def torch_seed(seed: int) -> int:
    """A seed of any size folded into torch's 64-bit range."""
    return seed % (2 ** 63)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = parameter_shapes(cfg)
    bn_names = {n for n in shapes
                if n.rsplit(".", 1)[-1] in BN_STATS and ("BatchNorm" in n or "batch_norm" in n)}
    normal_names = [n for n in shapes if n not in bn_names]
    n_normal = sum(math.prod(shapes[n]) for n in normal_names)
    n_uniform = sum(math.prod(shapes[n]) for n in bn_names)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        if name in bn_names:
            u = uniform[j:j + size].reshape(shape)
            j += size
            stat = name.rsplit(".", 1)[-1]
            out[name] = {"weight": 0.7 + 0.6 * u, "bias": 0.2 * (u - 0.5),
                         "running_mean": 0.2 * (u - 0.5), "running_var": 0.5 + u}[stat]
            continue
        z = normal[i:i + size].reshape(shape)
        i += size
        if len(shape) == 1 or name.endswith("score_pre_s"):
            out[name] = 0.1 * z
        else:
            out[name] = z / math.sqrt(math.prod(shape[1:]))
    return out
