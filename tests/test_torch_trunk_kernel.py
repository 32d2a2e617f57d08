"""The fused-trunk serving path of the PyTorch port held against the JAX
package: the segment plan, the folded trunk weights, the plain versions of
the v1 and v2 trunks against the Pallas trunks in interpret mode, the model
with a trunk_fn, make_eval_fn(use_fused_trunk=True) and its sibling options,
the trained b12c128btl3 golden, and two plies of self-play on the fused
eval. On the CPU the kernels' wrappers run their plain versions, which
round to bf16 at exactly the Pallas kernels' points; what differs from JAX
is the float32 summation order, which flips a rare bf16 rounding by one
unit and propagates through the residual stream. The tolerances below say
how far that carries."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.nn import trunk_kernel as jtk
from p3achygo_tpu.nn import trunk_kernel2 as jtk2
from p3achygo_tpu_torch.bridge import load_flax_variables
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import legal_mask_batch, new_state, superko_violation
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.blocks import mish, mish_f32
from p3achygo_tpu_torch.models.config import ModelConfig, get_config
from p3achygo_tpu_torch.models.model import ModelOutputs, build_model, init_params
from p3achygo_tpu_torch.nn import build_trunk_fn, build_trunk_fn_v2, trunk_supported
from p3achygo_tpu_torch.nn import trunk_kernel as ttk
from p3achygo_tpu_torch.nn import trunk_kernel2 as ttk2
from p3achygo_tpu_torch.ops import trunk as ops
from p3achygo_tpu_torch.selfplay import loop as tl
from torch_parity import numpy_vars, random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_B12 = os.path.join(ROOT, "results", "b12-onegen", "model_0001")


def _jax_init(jm, seed):
    return jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 19, 19, 15)), jnp.zeros((1, 8)),
        train=False)


@functools.lru_cache(maxsize=None)
def _bridged(name):
    """(JAX model, numpy variables with perturbed BN, port model), float32."""
    jm = jax_build(jax_get_config(name))
    v = numpy_vars(_jax_init(jm, 3), np.random.default_rng(0))
    return jm, v, load_flax_variables(build_model(get_config(name), device="cpu"), v)


def _trunk_input(n, channels, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 19, 19, channels)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    planes = (rng.random((B, 19, 19, 15)) < 0.3).astype(np.float32)
    scalars = rng.normal(size=(B, 8)).astype(np.float32)
    return planes, scalars


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kinds", [
    ("btl", "btl", "bc", "btl"),
    ("bc",),
    ("btl", "btl", "btl", "bc", "btl", "btl"),
    ("btl", "btl", "btl", "bc") * 3,
    ("bc", "bc", "btl"),
])
def test_plan_segments_match_jax(kinds):
    assert ttk2._plan_segments(kinds) == jtk2._plan_segments(kinds)
    assert ttk._plan_segments(kinds) == jtk2._plan_segments(kinds)


def test_mish_f32_matches_jax_formula():
    x = np.linspace(-30.0, 30.0, 20001, dtype=np.float32)
    got = mish_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jtk._mish_f32(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    # The plain `mish` is the other formula: equal to float32 rounding.
    np.testing.assert_allclose(mish(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "b8c64"])
def test_trunk_weights_match_jax(name):
    _, v, tm = _bridged(name)
    cfg = get_config(name)
    j_kinds, j_arrs = jtk.build_trunk_weights(jax_get_config(name), v)
    t_kinds, t_arrs = ttk.build_trunk_weights(cfg, tm)
    assert t_kinds == j_kinds
    assert len(t_arrs) == len(j_arrs)
    if name == "tiny":
        assert [k for k, _, _ in ttk._plan_segments(t_kinds)] == ["btl", "bc", "btl"]
    pos = 361
    for i, (t, j) in enumerate(zip(t_arrs, j_arrs)):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16 and t.shape[0] == ops.MIX_PAD:  # WdT
            assert j.shape == (384, 384)
            assert torch.equal(t[:pos, :pos].float(),
                               torch.from_numpy(j[:pos, :pos].astype(np.float32))), i
            assert not bool(t[pos:].any()) and not bool(t[:, pos:].any())
        elif t.dtype == torch.bfloat16:  # W: bit-equal
            assert t.shape == j.shape, i
            assert torch.equal(t.view(torch.int16),
                               torch.from_numpy(np.array(j).view(np.int16))), i
        elif t.shape == (pos,):  # bd
            np.testing.assert_array_equal(t.numpy(), j[:pos, 0])
        else:  # affines a, b: [C] vs JAX [1, C]
            np.testing.assert_allclose(t.numpy(), j[0], rtol=0, atol=1e-6,
                                       err_msg=str(i))
    _, v2_arrs = ttk2.build_trunk_weights_v2(cfg, tm)
    _, jv2_arrs = jtk2.build_trunk_weights_v2(jax_get_config(name), v)
    for t, j in zip(v2_arrs, jv2_arrs):
        if t.shape == (pos, pos):  # Wd, un-transposed
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j[:pos, :pos], np.float32))


# Max |d| / max |ref| of the trunk output. The plain v1 trunk rounds where
# the Pallas v1 kernel rounds; v2's broadcast blocks run in interpret mode
# with float32 operands (`_bc_block_xla(f32_dots=True)`) where the port
# rounds them to bf16 as the TPU does, so v2 is held to bf16 scale.
TRUNK_TOL = {"v1": 1e-2, "v2": 3e-2}


@pytest.mark.parametrize("name", ["tiny", "b8c64"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_plain_trunk_matches_pallas_interpret(name, version):
    _, v, tm = _bridged(name)
    cfg, jcfg = get_config(name), jax_get_config(name)
    x = _trunk_input(3, cfg.channels, seed=5)
    if version == "v1":
        jfn = jtk.build_trunk_fn(jcfg, v, n_tile=2, interpret=True)
        tfn = build_trunk_fn(cfg, tm)
    else:
        jfn = jtk2.build_trunk_fn_v2(jcfg, v, interpret=True)
        tfn = build_trunk_fn_v2(cfg, tm)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tfn(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    rel = _rel(got.float().numpy(), want)
    assert rel < TRUNK_TOL[version], rel


def test_plain_trunk_v1_equals_reference_and_v2_segments():
    """The v1 and v2 trunks share the segment kernel: on a trunk with no
    broadcast block they are the same function."""
    cfg = ModelConfig(blocks=3, broadcast_interval=8, inner_bottleneck_layers=2,
                      channels=16, bottleneck_channels=16, head_channels=8, c_val=8)
    tm = build_model(cfg, device="cpu")
    init_params(tm, torch.Generator().manual_seed(2))
    x = torch.from_numpy(_trunk_input(2, 16, seed=1))
    fn = build_trunk_fn(cfg, tm)
    assert len(fn.segments) == 1 and fn.segments[0].kernel is ops.trunk_segment
    out = fn(x)
    assert torch.equal(out, ttk.trunk_reference(x, fn.segments))
    assert torch.equal(out, build_trunk_fn_v2(cfg, tm)(x))
    empty = fn(torch.zeros((0, 19, 19, 16)))
    assert empty.shape == (0, 19, 19, 16) and empty.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["tiny", "b8c64"])
def test_model_with_trunk_fn_matches_jax(name):
    """At least as tight as tests/test_trunk_kernel.py:49-58 (float32
    models, so the stem and heads agree to float32 and only the trunk's
    summation order differs), with top-1 equal."""
    jm, v, tm = _bridged(name)
    planes, scalars = _inputs(4, 9)
    jfn = jtk.build_trunk_fn(jax_get_config(name), v, n_tile=2, interpret=True)
    jo = jax.jit(lambda p, s: jm.apply(v, p, s, train=False, trunk_fn=jfn))(
        planes, scalars)
    to = tm(torch.from_numpy(planes), torch.from_numpy(scalars),
            trunk_fn=build_trunk_fn(get_config(name), tm))
    for f in ModelOutputs._fields:
        assert getattr(to, f).dtype == torch.float32, f
        assert bool(torch.isfinite(getattr(to, f)).all()), f
    np.testing.assert_allclose(to.pi_logits.numpy(), np.asarray(jo.pi_logits),
                               atol=0.05, rtol=0.02)
    np.testing.assert_allclose(to.outcome_probs.numpy(),
                               np.asarray(jo.outcome_probs), atol=0.01)
    np.testing.assert_allclose(to.score_probs.numpy(), np.asarray(jo.score_probs),
                               atol=0.01)
    np.testing.assert_array_equal(to.pi_logits.argmax(-1).numpy(),
                                  np.asarray(jo.pi_logits).argmax(-1))


# (name, make_eval_fn options, tolerance): 1e-4 where no fused trunk runs
# (float32 throughout); bf16 scale where it does.
EVAL_CASES = [
    ("fused", dict(use_fused_trunk=True), 3e-2),
    ("serve_fold_wins", dict(use_fused_trunk=True, serve_fold=True), 1e-4),
    ("fused_nosym_popt", dict(use_fused_trunk=True, symmetrize=False,
                              p_opt_weight=0.3), 3e-2),
    ("fold_popt", dict(serve_fold=True, p_opt_weight=0.3), 1e-4),
    ("plain_nosym", dict(symmetrize=False), 1e-4),
]


@pytest.mark.parametrize("case,opts,tol", EVAL_CASES, ids=[c[0] for c in EVAL_CASES])
def test_eval_fn_matches_jax(case, opts, tol):
    jm, v, tm = _bridged("tiny")
    js = random_jax_states(B=4, moves=25, seed=2, pass_prob=0.05)
    j_eval = jg.make_eval_fn(jm, jax.tree_util.tree_map(jnp.asarray, v), **opts)
    je = jax.jit(j_eval)(js)
    te = tg.make_eval_fn(tm, **opts)(state_to_torch(js))
    for f in tg.EvalOutput._fields:
        np.testing.assert_allclose(getattr(te, f).numpy(), to_np(getattr(je, f)),
                                   rtol=tol, atol=tol, err_msg=f"{case}.{f}")
    np.testing.assert_array_equal(te.log_priors.argmax(-1).numpy(),
                                  np.asarray(je.log_priors).argmax(-1))
    if case == "serve_fold_wins":
        alone = tg.make_eval_fn(tm, serve_fold=True)(state_to_torch(js))
        for f in tg.EvalOutput._fields:
            assert torch.equal(getattr(te, f), getattr(alone, f)), f


def test_golden_b12c128btl3_fused_top1():
    """The trained b12c128btl3 golden: the plain fused-trunk model (bf16
    trunk) and the plain float32 model agree on top-1 on 8 positions from
    random legal play."""
    from p3achygo_tpu.train.checkpoint import restore_checkpoint

    jm = jax_build(jax_get_config("b12c128btl3"))
    tmpl = _jax_init(jm, 0)
    restored = restore_checkpoint(GOLDEN_B12, {"params": tmpl["params"],
                                               "batch_stats": tmpl["batch_stats"],
                                               "step": jnp.int32(0)})
    cfg = get_config("b12c128btl3")
    tm = load_flax_variables(build_model(cfg, device="cpu"), numpy_vars(restored))
    assert trunk_supported(cfg)
    states = state_to_torch(random_jax_states(B=8, moves=40, seed=7, pass_prob=0.02))
    planes, scalars = batched_features(states)
    plain = tm(planes, scalars)
    fused = tm(planes, scalars, trunk_fn=build_trunk_fn(cfg, tm))
    np.testing.assert_array_equal(fused.pi_logits.argmax(-1).numpy(),
                                  plain.pi_logits.argmax(-1).numpy())
    value = lambda o: (o.outcome_probs[:, 1] - o.outcome_probs[:, 0]).numpy()
    np.testing.assert_allclose(value(fused), value(plain), atol=0.05)


def test_selfplay_two_plies_on_fused_eval():
    _, _, tm = _bridged("tiny")
    B, cap = 4, 16
    cfg = tl.SelfplayConfig(batch_size=B)
    sel = tg.SearchParams(n=8, k=4, max_depth=6, visit_group=2)
    fast = tg.SearchParams(n=4, k=2, max_depth=6, visit_group=2)
    gen = torch.Generator().manual_seed(4)
    eval_fn = tg.make_eval_fn(tm, use_fused_trunk=True)
    states = new_state(B, cfg.komi, device="cpu")
    buf = tl.make_game_buffer(B, cfg.max_game_len, device="cpu")
    aux = tl.make_aux(B, gen, device="cpu")
    tree = make_tree(B, cap, device="cpu")
    b = torch.arange(B)
    for _ in range(2):
        prev = states
        states, buf, aux, tree = tl.selfplay_step_tiered(
            states, buf, aux, eval_fn, sel, fast, cfg, generator=gen,
            reuse_tree=tree, reuse_capacity=cap)
        t = prev.move_count.long()
        move = buf.move[b, t].long()
        assert bool(legal_mask_batch(prev)[b, move].all())
        assert not bool(superko_violation(prev, move).any())
        pi = buf.pi[b, t]
        assert bool(torch.isfinite(pi).all())
        torch.testing.assert_close(pi.sum(-1), torch.ones(B), rtol=0, atol=1e-5)
    assert bool((states.move_count == 2).all())


def test_wrappers_check_inputs_on_cpu():
    _, _, tm = _bridged("tiny")
    segments = build_trunk_fn(get_config("tiny"), tm).segments
    seg, bc = segments[0].weights, segments[1].weights
    x = torch.zeros((2, 361, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ops.trunk_segment(x.float(), seg)
    with pytest.raises(ValueError):
        ops.trunk_segment(x[:, :360], seg)
    with pytest.raises(ValueError):
        ops.trunk_broadcast(x, bc._replace(bd=bc.bd[:300]))
    before = (ops.trunk_segment.launches, ops.trunk_broadcast.launches)
    assert torch.equal(ops.trunk_segment(x, seg), ops.trunk_segment_reference(x, seg))
    assert torch.equal(ops.trunk_broadcast(x, bc),
                       ops.trunk_broadcast_reference(x, bc))
    assert (ops.trunk_segment.launches, ops.trunk_broadcast.launches) == before
