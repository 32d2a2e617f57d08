"""Seeded network weights, made on the device in a few large calls.

Every parameter of `reference.network.parameter_shapes` (the stem, the
configuration's trunk, the heads) comes from one normal and one uniform
draw of a `torch.Generator` on the device seeded from the run's seed, as
its draw rule says (`reference/network.py`: the trunk module's
`draw_rule` for the trunk, `network.draw_rule` for the rest): kernels
normal over the square root of their fan-in, biases and the score head's
per-bin term normal times 0.1, and norm statistics perturbed so that no
norm is an identity (scale in [0.7, 1.3), shift and mean in [-0.1, 0.1),
variance in [0.5, 1.5)). The parameters are float32, the type the model
stores and serves them in (it computes in bf16). The same dict goes to the
program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.harness.cells import BENCH_DIR, trunk_module
from portbench.reference import network

# A norm statistic from u uniform in [0, 1).
STATS = {"weight": lambda u: 0.7 + 0.6 * u, "bias": lambda u: 0.2 * (u - 0.5),
         "running_mean": lambda u: 0.2 * (u - 0.5), "running_var": lambda u: 0.5 + u}


def torch_seed(seed: int) -> int:
    """A seed of any size folded into torch's 64-bit range."""
    return seed % (2 ** 63)


def make_weights(cfg: dict, seed: int, device, bench_dir: str = BENCH_DIR
                 ) -> Dict[str, torch.Tensor]:
    trunk = trunk_module(cfg, bench_dir)
    own = trunk.parameter_shapes(cfg)
    rules = {name: (shape, (trunk.draw_rule if name in own else network.draw_rule)(name, shape))
             for name, shape in network.parameter_shapes(cfg, trunk).items()}
    size = {name: math.prod(shape) for name, (shape, _) in rules.items()}
    n_uniform = sum(size[n] for n, (_, r) in rules.items() if r[0] == "stat")
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    normal = torch.randn(sum(size.values()) - n_uniform, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, (shape, (kind, arg)) in rules.items():
        n = size[name]
        if kind == "stat":
            out[name] = STATS[arg](uniform[j:j + n].reshape(shape))
            j += n
            continue
        z = normal[i:i + n].reshape(shape)
        i += n
        if kind == "scale":
            out[name] = arg * z
        elif kind == "fan_in":
            out[name] = z / math.sqrt(arg)
        else:
            raise ValueError(f"{name}: unknown draw rule {(kind, arg)!r}")
    return out
