"""The transformer trunk of p3achygo (python/model_transformer.py; the
b14d96h3_transformer sizes are in python/model_config.py), in plain
float32 torch, as a trunk module of `reference/network.py`.

After the shared stem (C channels): `embed`, a Dense C -> E over each
point; `pos_embed`, a learned [19, 19, E] added; then `blocks` pre-LN
blocks over the 361 points as tokens, in the row-major order h * 19 + w:
    t = t + attn(LN_0(t))
    t = t + Dense_1(gelu(Dense_0(LN_1(t))))
with an MLP of 4E, and the heads read the E-wide grid, NCHW. LayerNorm
is over the last axis with eps 1e-6, a scale and a bias. The attention
has H heads of D = E / H: q, k and v each a projection E -> [H, D] with a
bias [H, D]; per head softmax(q / sqrt(D) . k^T) . v over the tokens; the
out projection [H, D] -> E with a bias [E]. gelu is the tanh
approximation. These are the JAX package's equations
(p3achygo_tpu/models/transformer.py, flax 0.12), the program's oracle.

Departures from the program's bf16 forward (p3achygo_tpu_torch/models/
transformer.py), all of them rounding, none of them an equation; here
everything is float32 with TF32 off (`network.float32_exact`):
- the program rounds to bf16 after every product and again after every
  bias add (flax's Dense: the product, then the bias);
- it divides q by sqrt(D) rounded to bf16 (5.65625 for D = 32, not
  5.6569), then rounds the quotient;
- its softmax is in bf16: exp(x - max) rounded, the sum (accumulated in
  float32) rounded, the quotient rounded; here torch's float32 softmax;
- its LayerNorm takes the variance as E[x^2] - E[x]^2 in float32 (flax's
  fast variance) and rounds its output to bf16; here the two-pass
  variance, the same number up to float32 rounding;
- its gelu and residual adds round to bf16.
`net.round`, where a caller gives one, rounds both inputs of every
product, the attention's two included.

Nothing here imports the program or JAX.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

from portbench.reference.network import BOARD, POINTS, dense_shapes

LN_EPS = 1e-6
MLP_RATIO = 4
PROJECTIONS = ("query", "key", "value")


def _ln(net, name: str, t: torch.Tensor) -> torch.Tensor:
    mean = t.mean(dim=-1, keepdim=True)
    var = ((t - mean) ** 2).mean(dim=-1, keepdim=True)
    return (t - mean) / torch.sqrt(var + LN_EPS) * net.p[f"{name}.weight"] + net.p[f"{name}.bias"]


def _project(net, name: str, t: torch.Tensor, k_axes: int) -> torch.Tensor:
    """flax DenseGeneral: t's last `k_axes` axes contracted with the first
    `k_axes` of the kernel, then its bias."""
    w = net.p[f"{name}.weight"]
    y = torch.tensordot(net.round(t), net.round(w), dims=k_axes)
    return y + net.p[f"{name}.bias"]


def _attention(net, name: str, t: torch.Tensor) -> torch.Tensor:
    """Self-attention of tokens [N, T, E] -> [N, T, E]."""
    q, k, v = (_project(net, f"{name}.{p}", t, 1).transpose(1, 2) for p in PROJECTIONS)
    scores = torch.matmul(net.round(q / math.sqrt(q.shape[-1])), net.round(k).transpose(-1, -2))
    y = torch.matmul(net.round(torch.softmax(scores, dim=-1)), net.round(v))
    return _project(net, f"{name}.out", y.transpose(1, 2), 2)


def parameter_shapes(cfg: dict):
    C, E, H = cfg["channels"], cfg["embed_dim"], cfg["num_heads"]
    D = E // H
    out = OrderedDict()
    dense_shapes(out, "embed", C, E)
    out["pos_embed.pos_embed"] = (BOARD, BOARD, E)
    for i in range(cfg["blocks"]):
        p = f"transformer_{i}"
        out[f"{p}.LayerNorm_0.weight"] = out[f"{p}.LayerNorm_0.bias"] = (E,)
        a = f"{p}.MultiHeadDotProductAttention_0"
        for proj in PROJECTIONS:
            out[f"{a}.{proj}.weight"] = (E, H, D)
            out[f"{a}.{proj}.bias"] = (H, D)
        out[f"{a}.out.weight"] = (H, D, E)
        out[f"{a}.out.bias"] = (E,)
        out[f"{p}.LayerNorm_1.weight"] = out[f"{p}.LayerNorm_1.bias"] = (E,)
        dense_shapes(out, f"{p}.Dense_0", E, MLP_RATIO * E)
        dense_shapes(out, f"{p}.Dense_1", MLP_RATIO * E, E)
    return out


def draw_rule(name: str, shape) -> tuple:
    """LayerNorm scale and bias as norm statistics (so that no norm is the
    identity), the positional embedding normal times 0.02 (flax's
    initializer), every bias normal times 0.1, and every kernel over its
    input axes: the last of a Dense's [out, in], the first of a q / k / v
    [E, H, D], all but the last of the out projection's [H, D, E]."""
    last = name.rsplit(".", 1)[-1]
    if ".LayerNorm_" in name:
        return ("stat", last)
    if name == "pos_embed.pos_embed":
        return ("scale", 0.02)
    if last == "bias":
        return ("scale", 0.1)
    if name.endswith(tuple(f"{p}.weight" for p in PROJECTIONS)):
        return ("fan_in", shape[0])
    if name.endswith("out.weight"):
        return ("fan_in", shape[0] * shape[1])
    return ("fan_in", shape[-1])


def forward(net, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    n, _, h, w = x.shape
    t = x.flatten(2).transpose(1, 2)  # [N, 361, C], token h * 19 + w
    t = net._dense("embed", t) + net.p["pos_embed.pos_embed"].reshape(POINTS, -1)
    for i in range(cfg["blocks"]):
        p = f"transformer_{i}"
        t = t + _attention(net, f"{p}.MultiHeadDotProductAttention_0",
                           _ln(net, f"{p}.LayerNorm_0", t))
        y = F.gelu(net._dense(f"{p}.Dense_0", _ln(net, f"{p}.LayerNorm_1", t)),
                   approximate="tanh")
        t = t + net._dense(f"{p}.Dense_1", y)
    return t.transpose(1, 2).reshape(n, -1, h, w)


def flops(cfg: dict) -> int:
    """One position's trunk, 2 operations a multiply-add: the embed, per
    block the four projections, the attention's two products (q.k^T and
    weights.v, 2 T^2 E each) and the MLP. LayerNorm, softmax, gelu and the
    adds are not counted."""
    C, E, T = cfg["channels"], cfg["embed_dim"], POINTS
    block = 2 * T * 4 * E * E + 4 * T * T * E + 2 * T * 2 * MLP_RATIO * E * E
    return 2 * T * C * E + cfg["blocks"] * block


def head_width(cfg: dict) -> int:
    return cfg["embed_dim"]
