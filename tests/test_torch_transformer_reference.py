"""The benchmark's plain float32 transformer trunk
(portbench/reference/trunks/transformer.py) against the port's transformer,
on the CPU: its parameters are the program's `state_dict`, names, order
and shapes; its weight draws; the port's float32 network and eval function
agree with the reference's evaluation on the same seeded weights at a
small size (2 blocks, width 32, 2 heads); the operation count by hand;
and the reference imports neither the port nor JAX."""
from __future__ import annotations

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from p3achygo_tpu_torch.game.board import from_stones
from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
from p3achygo_tpu_torch.models.config import ModelConfig, get_config
from p3achygo_tpu_torch.models.model import build_model
from portbench.harness import work
from portbench.harness.weights import STATS, make_weights
from portbench.reference import rules
from portbench.reference.network import Network, parameter_shapes
from portbench.reference.trunks import transformer as ref_trunk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = dict(trunk_block_type="transformer", is_transformer=True, blocks=2, conv_size=3,
             channels=32, embed_dim=32, num_heads=2, head_channels=8, c_val=16)
SEED = 2 ** 31 + 2222
# The port's float32 forward and the reference differ in summation order and
# in the variance formula alone (flax's E[x^2] - E[x]^2 against the
# two-pass one), so both read within a few float32 ulps a layer: 2.9e-6 in
# log-prior and 2.4e-7 in value at this size and seed. 1e-4 leaves a
# margin of ~35x, and the port in bf16 (4.7e-2) is far outside it.
F32_TOL = 1e-4


def published():
    with open(os.path.join(ROOT, "portbench", "configs", "b14d96h3_transformer.json")) as f:
        return json.load(f)


def program_config(cfg: dict) -> ModelConfig:
    return ModelConfig(**{k: v for k, v in cfg.items() if k in ModelConfig.__dataclass_fields__})


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("which", ["small", "published"])
def test_parameters_are_the_programs_state_dict(which):
    cfg = SMALL if which == "small" else published()
    model = build_model(program_config(cfg), torch.float32, "cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = parameter_shapes(cfg, ref_trunk)
    assert list(got) == list(want) and dict(got) == want
    if which == "published":
        # The file's sizes are the registry's (c_l2 is a training setting).
        assert program_config(cfg) == dataclasses.replace(
            get_config("b14d96h3_transformer"), c_l2=ModelConfig.c_l2)
        assert 1.5e6 < sum(np.prod(s) for s in got.values()) < 2.0e6


def test_weight_draws():
    p = make_weights(SMALL, SEED, CPU)
    ln = p["transformer_1.LayerNorm_0.weight"]
    assert ((ln >= 0.7) & (ln < 1.3)).all() and ln.std() > 0.05
    ln_b = p["transformer_0.LayerNorm_1.bias"]
    assert (ln_b.abs() <= 0.1).all() and ln_b.abs().max() > 0.0
    assert 0.015 < float(p["pos_embed.pos_embed"].std()) < 0.025
    # q [E, H, D] over its E inputs; out [H, D, E] over H * D; a Dense over its last axis.
    assert 0.8 < float(p["transformer_0.MultiHeadDotProductAttention_0.query.weight"].std()
                       * 32 ** 0.5) < 1.2
    assert 0.8 < float(p["transformer_0.MultiHeadDotProductAttention_0.out.weight"].std()
                       * 32 ** 0.5) < 1.2
    assert 0.8 < float(p["transformer_1.Dense_1.weight"].std() * 128 ** 0.5) < 1.2
    assert 0.07 < float(p["transformer_1.MultiHeadDotProductAttention_0.key.bias"].std()) < 0.13
    rules_ = [ref_trunk.draw_rule(*kv) for kv in parameter_shapes(SMALL, ref_trunk).items()]
    assert {r[1] for r in rules_ if r[0] == "stat"} == {"weight", "bias"} <= set(STATS)


def _positions(n: int, seed: int):
    rng = np.random.default_rng(seed)
    stones, to_move, moves = rules.random_games(rng.integers(0, 120, n), rng)
    last = np.full((n, 5), -1, np.int64)
    for b in range(n):
        played = [int(m) for m in moves[b] if m >= 0][-5:]
        if played:
            last[b, -len(played):] = played
    states = from_stones(torch.from_numpy(stones), 7.5, torch.from_numpy(to_move), device="cpu")
    return states._replace(last_moves=torch.from_numpy(last).to(torch.int32)), stones, to_move, last


def test_float32_program_against_the_reference():
    """The program's float32 eval function (symmetry, features, network,
    reductions) and the reference's `Network.evaluate` on the same weights:
    log-priors and value within `F32_TOL`; the bf16 program outside it."""
    params = make_weights(SMALL, SEED, CPU)
    states, stones, to_move, last = _positions(16, 3)
    ref = Network(SMALL, params, CPU, ref_trunk).evaluate(stones, to_move, last,
                                                          np.full(16, 7.5, np.float32))
    gaps = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(program_config(SMALL), dtype, "cpu")
        model.load_state_dict(params)
        out = make_eval_fn(model, symmetrize=True)(states)
        gaps[dtype] = ((out.log_priors - ref.log_priors).abs().max().item(),
                       (out.outcome_value - ref.value).abs().max().item())
    assert max(gaps[torch.float32]) < F32_TOL, gaps
    assert gaps[torch.bfloat16][0] > 10 * F32_TOL, gaps
    assert ref.value.abs().max() > 0.1 and ref.log_priors.std() > 0.05


@pytest.mark.parametrize("which", ["small", "published"])
def test_flops_by_hand(which):
    cfg = SMALL if which == "small" else published()
    C, E, T = cfg["channels"], cfg["embed_dim"], 361
    qkv_out = 4 * T * E * E  # q, k, v and out: multiply-adds
    scores_and_mix = 2 * T * T * E  # q.k^T and weights.v over all heads
    mlp = 2 * T * E * 4 * E
    want = 2 * (T * C * E + cfg["blocks"] * (qkv_out + scores_and_mix + mlp))
    assert ref_trunk.flops(cfg) == want
    if which == "small":
        assert want == 2 * (361 * 32 * 32 + 2 * (4 * 361 * 1024 + 2 * 130321 * 32
                                                  + 8 * 361 * 1024))
    else:
        # 1.82 GFLOP a position, 0.70 of it in the attention's two products.
        assert 1.80e9 < want < 1.85e9
        assert 0.69e9 < 2 * 14 * scores_and_mix < 0.71e9
        assert work.model_flops(cfg) - want < 0.1e9


def test_the_reference_trunk_imports_neither_the_port_nor_jax():
    tree = ast.parse(open(ref_trunk.__file__).read())
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "p3achygo_tpu",
                                           "p3achygo_tpu_torch"), m
