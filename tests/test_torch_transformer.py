"""The transformer trunk of the PyTorch port held against the JAX package
on seeded numpy inputs: TransformerBlock and PositionalEmbedding against
flax in float32, the b14d96h3_transformer network cut to two blocks (full
width: embed 96, 3 heads of 32) on all 25 outputs in float32 and bf16,
the bridge's transformer leaves, one ConvMuon and one sgd_nesterov train
step against JAX run in float64, make_eval_fn's serve_fold fallback, and
one selfplay_step_tiered ply with the transformer evaluator."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.models import losses as jlosses
from p3achygo_tpu.models.transformer import PositionalEmbedding as JaxPosEmbed
from p3achygo_tpu.models.transformer import TransformerBlock as JaxBlock
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu.train import optimizer as jopt
from p3achygo_tpu.train.step import create_train_state as jax_create_train_state
from p3achygo_tpu.train.step import make_train_step as jax_make_train_step
from p3achygo_tpu_torch.bridge import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
    to_flax_layout,
)
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.models import losses as tlosses
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import ModelOutputs, build_model, init_params
from p3achygo_tpu_torch.models.transformer import PositionalEmbedding, TransformerBlock
from p3achygo_tpu_torch.selfplay import loop as tl
from p3achygo_tpu_torch.train import optimizer as topt
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step
from torch_parity import random_jax_states, state_to_torch, tiered_step_draws, to_np

torch.set_num_threads(2)

NAME = "b14d96h3_transformer"
JCFG = dataclasses.replace(jax_get_config(NAME), blocks=2)
TCFG = dataclasses.replace(get_config(NAME), blocks=2)
F32_TOL = 1e-4
# Biases that add one constant to a whole softmax row (the attention's key
# bias adds q.b to every score of a query; the score head's output bias
# to every score bin), so their exact gradient is 0 and both frameworks'
# gradients are rounding noise, which AdamW's first step,
# m / (sqrt(v) + eps), scales up to ~lr. sgd_nesterov's update of them,
# lr * g, is compared.
SHIFT_INVARIANT = (("key", "bias"), ("score_output", "bias"))


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    planes = (rng.random((B, 19, 19, 15)) < 0.3).astype(np.float32)
    return planes, rng.normal(size=(B, 8)).astype(np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def nets():
    """(flax model, numpy variables, the port's float32 model with them).
    The weights are the port's seeded init carried to flax, with the
    policy, value and score heads sharpened as torch_parity.tiny_pair does
    (a random net's policy is near uniform) and every LayerNorm and bias
    perturbed, so no affine is an identity."""
    tm = build_model(TCFG, device="cpu")
    init_params(tm, torch.Generator().manual_seed(7))
    v = jax.tree_util.tree_map(np.array, state_dict_to_flax(tm.state_dict()))
    rng = np.random.default_rng(8)
    for path, a in _flat(v["params"]):
        if path[-1] in ("bias", "scale") and path[0].startswith("transformer"):
            a += rng.normal(0, 0.1, a.shape).astype(np.float32)
    v["params"]["policy_head"]["output_moves"]["kernel"] *= 30.0
    v["params"]["value_head"]["outcome_q_output"]["kernel"] *= 10.0
    v["params"]["value_head"]["score_pre_s"] *= 0.02
    load_flax_variables(tm, v)
    return jax_build(JCFG), v, tm


def test_block_and_positional_embedding_against_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 19, 19, 96)).astype(np.float32)
    jblock = JaxBlock(96, 3)
    variables = jax.jit(jblock.init)(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        variables["params"])
    want = np.asarray(jax.jit(jblock.apply)({"params": params}, x))
    tb = TransformerBlock(96, 96, 3)
    tb.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    got = tb(torch.from_numpy(x).reshape(3, 361, 96)).reshape(3, 19, 19, 96)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)

    jpos = JaxPosEmbed()
    pvars = jax.tree_util.tree_map(np.asarray, jax.jit(jpos.init)(jax.random.PRNGKey(2), x))
    tp = PositionalEmbedding(96)
    tp.load_state_dict(flax_to_state_dict(pvars), strict=True)
    got = tp(torch.from_numpy(x).reshape(3, 361, 96)).reshape(3, 19, 19, 96)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jax.jit(jpos.apply)(pvars, x)))


def test_model_all_outputs_float32(nets):
    jm, v, tm = nets
    planes, scalars = _inputs(4, 3)
    jo = jax.jit(lambda v, p, s: jm.apply(v, p, s, train=False))(v, planes, scalars)
    to = tm(torch.from_numpy(planes), torch.from_numpy(scalars))
    assert len(ModelOutputs._fields) == 25
    for f in ModelOutputs._fields:
        assert getattr(to, f).dtype == torch.float32, f
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f)


def test_model_all_outputs_bf16(nets):
    """bf16 on both sides, 16 positions. Tolerance per output: twice JAX's
    own bf16 error against its float32 forward, plus one bf16 unit (2^-8)
    of the output's largest magnitude: the two frameworks round the same
    products at the same points but sum them in other orders, so the
    port's bf16 may be as far from JAX's as JAX's is from float32. Policy
    top-1 agreement with JAX's bf16 is printed and must be >= 15/16."""
    jm, v, tm = nets
    planes, scalars = _inputs(16, 4)
    j32 = jax.jit(lambda v, p, s: jm.apply(v, p, s, train=False))(v, planes, scalars)
    jm16 = jax_build(JCFG, dtype=jnp.bfloat16)
    j16 = jax.jit(lambda v, p, s: jm16.apply(v, p, s, train=False))(v, planes, scalars)
    t16 = build_model(TCFG, torch.bfloat16, device="cpu")
    t16.load_state_dict(tm.state_dict())
    to = t16(torch.from_numpy(planes), torch.from_numpy(scalars))
    for f in ModelOutputs._fields:
        ref, want = np.asarray(getattr(j32, f)), np.asarray(getattr(j16, f))
        got = getattr(to, f).numpy()
        assert got.dtype == np.float32 and np.isfinite(got).all(), f
        bound = 2 * np.abs(want - ref).max() + 2.0 ** -8 * np.abs(ref).max()
        assert np.abs(got - want).max() <= bound, (f, np.abs(got - want).max(), bound)
    top1 = float((to.pi_logits.argmax(-1).numpy() == np.asarray(j16.pi_logits).argmax(-1)).mean())
    print(f"bf16 policy top-1 agreement with JAX: {top1:.4f}")
    assert top1 >= 15 / 16


def test_bridge_transformer_leaves(nets):
    """Every flax leaf maps to one tensor of the port, whose flax layout has
    exactly the flax shape (ConvMuon's flattening reads it), and the
    round trip is the identity."""
    _, v, tm = nets
    shapes = jax.eval_shape(lambda: jax_build(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 19, 19, 15)), jnp.zeros((1, 8))))
    want = {"/".join(p): tuple(s.shape) for p, s in _flat(
        jax.tree_util.tree_map(lambda s: np.empty(s.shape), shapes["params"]))}
    sd = dict(tm.named_parameters())
    got = {"/".join(p): a.shape for p, a in _flat(state_dict_to_flax(sd)["params"])}
    assert got == want
    assert set(flax_to_state_dict(v)) == set(tm.state_dict())
    for k, t in sd.items():
        path = k.rsplit(".", 1)[0].replace(".", "/")
        leaf = {"weight": "scale" if t.dim() == 1 else "kernel"}.get(k.rsplit(".", 1)[1],
                                                                      k.rsplit(".", 1)[1])
        assert tuple(to_flax_layout(t, k).shape) == want[f"{path}/{leaf}"], k
    for part in ("params", "batch_stats"):
        back = dict(_flat(state_dict_to_flax(flax_to_state_dict(v))[part]))
        orig = dict(_flat(v[part]))
        assert back.keys() == orig.keys()
        for k in orig:
            np.testing.assert_array_equal(back[k], orig[k], err_msg="/".join(k))
    pos = "transformer_0.MultiHeadDotProductAttention_0"
    assert to_flax_layout(sd[f"{pos}.query.bias"], f"{pos}.query.bias").shape == (3, 32)
    assert to_flax_layout(sd[f"{pos}.out.weight"], f"{pos}.out.weight").shape == (3, 32, 96)


def _replay_rows(N, seed):
    rng = np.random.default_rng(seed)
    stones = np.asarray(random_jax_states(N, 30, seed).stones)
    dist = lambda: rng.dirichlet(np.full(362, 0.3), N).astype(np.float32)
    score = rng.normal(0, 30, N).astype(np.float32)
    return dict(
        stones=stones, last_moves=rng.integers(-1, 362, (N, 5)).astype(np.int16),
        color=rng.choice([1, -1], N).astype(np.int8), komi=np.full(N, 7.5, np.float32),
        pi=dist(), pi_aux=rng.integers(0, 362, N).astype(np.int16), pi_aux_dist=dist(),
        has_pi_aux_dist=rng.random(N) < 0.6, own=rng.integers(-1, 2, (N, 361)).astype(np.int8),
        score_margin=score, z=np.where(score > 0, 1.0, -1.0).astype(np.float32),
        **{k: np.tanh(rng.normal(0, 1, N)).astype(np.float32) for k in ("q6", "q16", "q50")},
        **{k: rng.normal(0, 10, N).astype(np.float32)
           for k in ("q6_score", "q16_score", "q50_score")},
        weight=np.ones(N, np.float32),
        mcts_value_dist=rng.integers(0, 20, (N, 51)).astype(np.uint16))


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64 if np.issubdtype(np.asarray(x).dtype, np.floating)
                              else np.asarray(x).dtype), tree)


@pytest.mark.parametrize("opt", ["conv_muon", "sgd_nesterov"])
def test_train_step_against_jax_float64(nets, opt):
    """One train step of each optimizer, the port in float32 against JAX in
    float64 (the reason: tests/test_torch_train.py); ConvMuon takes the
    attention kernels and the positional embedding by their flax shapes
    (pos_embed as [361, 96], q/k/v as [288, 32], out as [96, 96]) and the
    [3, 32] biases and LayerNorm vectors by AdamW. Tolerances those of
    test_torch_train: rtol 1e-4, atol 1e-6."""
    _, v, _ = nets
    rows = _replay_rows(8, 5)
    planes, scalars, targets = prepare_batch(rows, augment=False, device="cpu")
    coeffs_j, coeffs_t = jlosses.LossCoeffs.rl(), tlosses.LossCoeffs.rl()
    jtx, ttx = ((jopt.conv_muon(2e-2), topt.conv_muon(2e-2)) if opt == "conv_muon"
                else (jopt.sgd_nesterov(1e-2), topt.sgd_nesterov(1e-2)))
    with jax.enable_x64(True):
        jm64 = jax_build(JCFG, dtype=jnp.float64)
        jstate = jax_create_train_state(_f64(v), jtx)
        jt = jlosses.GroundTruth(*_f64(tuple(t.numpy() for t in targets)))
        jstate, jloss = jax.jit(jax_make_train_step(jm64, jtx, coeffs_j))(
            jstate, _f64(planes.numpy()), _f64(scalars.numpy()), jt)
        jloss = {k: float(x) for k, x in jloss.items()}
        want = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}
    tm = load_flax_variables(build_model(TCFG, device="cpu"), v)
    tstate = create_train_state(tm, ttx)
    tstate, tloss = make_train_step(tm, ttx, coeffs_t)(tstate, planes, scalars, targets)
    for k in jloss:
        np.testing.assert_allclose(float(tloss[k]), jloss[k], rtol=1e-4, atol=1e-6, err_msg=k)
    got = state_dict_to_flax(tm.state_dict())
    for part in ("params", "batch_stats"):
        g, w = dict(_flat(got[part])), dict(_flat(want[part]))
        assert g.keys() == w.keys()
        for k in w:
            if opt == "conv_muon" and k[-2:] in SHIFT_INVARIANT:
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{opt} {part} {'/'.join(k)}")
    if opt == "conv_muon":
        muon = {k for k, p in tstate.params.items()
                if topt._is_muon_leaf(to_flax_layout(p, k).shape)}
        attn = "transformer_1.MultiHeadDotProductAttention_0"
        assert {"pos_embed.pos_embed", f"{attn}.query.weight",
                f"{attn}.out.weight"} <= muon
        assert not {f"{attn}.query.bias", "transformer_1.LayerNorm_0.weight"} & muon


def test_serve_fold_falls_back_to_the_plain_forward(nets):
    """serve_supported is false for the transformer: make_eval_fn with
    serve_fold (and use_fused_trunk, which trunk_supported ignores) gives
    the plain forward's outputs exactly."""
    _, _, tm = nets
    from p3achygo_tpu_torch.nn.serve import serve_supported

    assert not serve_supported(TCFG) and serve_supported(get_config("tiny"))
    states = state_to_torch(random_jax_states(4, 20, 9))
    plain = tg.make_eval_fn(tm)(states)
    for kw in (dict(serve_fold=True), dict(use_fused_trunk=True),
               dict(serve_fold=True, use_fused_trunk=True)):
        got = tg.make_eval_fn(tm, **kw)(states)
        for f in tg.EvalOutput._fields:
            assert torch.equal(getattr(got, f), getattr(plain, f)), (kw, f)


def test_selfplay_tiered_ply_with_the_transformer(nets):
    """One selfplay_step_tiered ply, 6 boards, the transformer evaluator in
    float32 on both sides and JAX's draws injected: moves, stones and
    visit counts equal, improved policies within 1e-4."""
    jm, v, tm = nets
    B = 6
    j_sel, j_fast = jg.SearchParams(n=4, k=2, max_depth=4), jg.SearchParams(n=2, k=2, max_depth=4)
    t_sel, t_fast = tg.SearchParams(n=4, k=2, max_depth=4), tg.SearchParams(n=2, k=2, max_depth=4)
    cfg_j, cfg_t = jl.SelfplayConfig(batch_size=B), tl.SelfplayConfig(batch_size=B)
    j_eval = jg.make_eval_fn(jm, jax.tree_util.tree_map(jnp.asarray, v), serve_fold=True)
    js = random_jax_states(B, 20, 10, pass_prob=0.05)
    ts = state_to_torch(js)
    jaux = jl.make_aux(jax.random.PRNGKey(3), B)
    taux = tl.make_aux(B, raw_until=torch.tensor(np.array(jaux.raw_until)), device="cpu")
    key = jax.random.PRNGKey(12)
    draws = tiered_step_draws(key, B, tl.tier_sizes(B, cfg_t)[0])
    js2, jbuf, _, _ = jax.jit(functools.partial(
        jl.selfplay_step_tiered, eval_fn=j_eval, params_sel=j_sel, params_fast=j_fast,
        cfg=cfg_j))(js, jl.make_game_buffer(B, cfg_j.max_game_len), jaux, key)
    ts2, tbuf, _ = tl.selfplay_step_tiered(
        ts, tl.make_game_buffer(B, cfg_t.max_game_len, device="cpu"), taux,
        tg.make_eval_fn(tm, serve_fold=True), t_sel, t_fast, cfg_t, draws=draws)
    b, t = np.arange(B), to_np(js.move_count)
    for f, atol in (("move", 0), ("visits", 0), ("pi", 1e-4)):
        np.testing.assert_allclose(getattr(tbuf, f).numpy()[b, t], to_np(getattr(jbuf, f))[b, t],
                                   rtol=0, atol=atol, err_msg=f)
    np.testing.assert_array_equal(ts2.stones.numpy(), to_np(js2.stones))


def test_bn_refresh_and_checkpoint_round_trip(nets, tmp_path):
    """The transformer on the rest of the training path: a BN refresh
    (recompute_batch_stats) moves only the heads' BatchNorm statistics, the
    one BatchNorm of this network, and leaves every parameter as it was; a
    checkpoint restores into a fresh model bitwise."""
    from p3achygo_tpu_torch.train import checkpoint
    from p3achygo_tpu_torch.train.swa import recompute_batch_stats

    _, _, tm = nets
    m = build_model(TCFG, device="cpu")
    m.load_state_dict(tm.state_dict())
    before = {k: v.clone() for k, v in m.state_dict().items()}
    planes, scalars = _inputs(4, 6)
    assert recompute_batch_stats(m, [(torch.from_numpy(planes), torch.from_numpy(scalars))] * 2) == 2
    moved = {k for k, v in m.state_dict().items() if not torch.equal(v, before[k])}
    assert moved and all(k.startswith(("policy_head.", "value_head.")) and
                         k.endswith(("running_mean", "running_var")) for k in moved), moved
    path = checkpoint.save_checkpoint(str(tmp_path), 1, {"model": m.state_dict()})
    fresh = build_model(TCFG, device="cpu")
    fresh.load_state_dict(checkpoint.restore_checkpoint(path)["model"])
    assert all(torch.equal(v, m.state_dict()[k]) for k, v in fresh.state_dict().items())
