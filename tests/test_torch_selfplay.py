"""The ported slice as a whole held against the JAX package: the `tiny`
network (float32, bridged weights) behind make_eval_fn(serve_fold=True),
two plies of selfplay_step_tiered with tree reuse, then reset_finished,
with every JAX random draw injected into the port.

Moves and visit counts must agree exactly, except on boards where the JAX
search's top two improved-policy entries are closer than 1e-4 (a float
rounding difference of the two frameworks may then pick the other move);
such boards are counted, printed and left out of the exact checks from
that ply on. Floats agree to 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.mcts import tree as jt
from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu_torch.bridge import load_flax_variables
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts import tree as tt
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import build_model
from p3achygo_tpu_torch.selfplay import loop as tl
from torch_parity import random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

B = 8
CAP = 24
J_SEL = jg.SearchParams(n=16, k=4, max_depth=8, visit_group=2)
J_FAST = jg.SearchParams(n=8, k=2, max_depth=8, visit_group=2)
T_SEL = tg.SearchParams(n=16, k=4, max_depth=8, visit_group=2)
T_FAST = tg.SearchParams(n=8, k=2, max_depth=8, visit_group=2)


def _gumbel(key, n):
    return torch.tensor(np.array(jax.random.gumbel(key, (n, 362))))


def _step_draws(key, b_sel):
    """The draws of one JAX selfplay_step_tiered call (loop.py:394-499,
    gumbel.py:850-851, 1579-1584), in the port's StepDraws."""
    _, kperm, ks1, ks2, kr1, kr2, ksel = jax.random.split(key, 7)

    def search(ks, n):
        k1, knoise = jax.random.split(ks)
        _, ksample = jax.random.split(k1)
        return _gumbel(knoise, n), _gumbel(ksample, n)

    sel_noise, sel_sample = search(ks1, b_sel)
    fast_noise, fast_sample = search(ks2, B - b_sel)
    u = lambda k: torch.tensor(np.array(jax.random.uniform(k, (B,))))
    return tl.StepDraws(perm_u=u(kperm), sel_noise=sel_noise,
                        sel_sample=sel_sample, fast_noise=fast_noise,
                        fast_sample=fast_sample, sel_raw=_gumbel(kr1, b_sel),
                        fast_raw=_gumbel(kr2, B - b_sel), train_u=u(ksel))


def _near_tie_boards(pi):
    top2 = np.sort(np.asarray(pi), axis=-1)[:, -2:]
    return set(np.flatnonzero(top2[:, 1] - top2[:, 0] < 1e-4).tolist())


def _compare(jx, tx, skip, what):
    """NamedTuples of [B, ...] arrays: integers exact, floats to 1e-4, rows
    in `skip` left out."""
    keep = np.array([i for i in range(B) if i not in skip], np.int64)
    for f in type(tx)._fields:
        a = to_np(getattr(jx, f))[keep]
        b = getattr(tx, f)
        b = (b.float() if b.dtype == torch.bfloat16 else b).numpy()[keep]
        if str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4,
                                       err_msg=f"{what}.{f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}.{f}")


def test_selfplay_slice_parity():
    jm = jax_build(jax_get_config("tiny"))
    variables = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(5), jnp.zeros((1, 19, 19, 15)), jnp.zeros((1, 8)),
        train=False)
    np_vars = jax.tree_util.tree_map(np.array, variables)
    # A random tiny net's policy is near uniform, so improved-policy ties
    # would be everywhere: sharpen the policy and value outputs. Its score
    # head puts all mass on an end bin (|score| ~ 400, where float32 sums
    # carry 1e-4 of rounding): flatten the per-bin term to keep scores
    # game-sized.
    np_vars["params"]["policy_head"]["output_moves"]["kernel"] *= 30.0
    np_vars["params"]["value_head"]["outcome_q_output"]["kernel"] *= 10.0
    np_vars["params"]["value_head"]["score_pre_s"] *= 0.02
    tm = load_flax_variables(build_model(get_config("tiny")), np_vars)
    j_eval = jg.make_eval_fn(jm, jax.tree_util.tree_map(jnp.asarray, np_vars),
                             serve_fold=True)
    t_eval = tg.make_eval_fn(tm, serve_fold=True)
    cfg_j = jl.SelfplayConfig(batch_size=B)
    cfg_t = tl.SelfplayConfig(batch_size=B)
    b_sel, _ = tl.tier_sizes(B, cfg_t)

    j_step = jax.jit(functools.partial(
        jl.selfplay_step_tiered, eval_fn=j_eval, params_sel=J_SEL,
        params_fast=J_FAST, cfg=cfg_j, reuse_capacity=CAP))

    js = random_jax_states(B=B, moves=20, seed=6, pass_prob=0.05)
    ts = state_to_torch(js)
    jbuf = jl.make_game_buffer(B, cfg_j.max_game_len)
    tbuf = tl.make_game_buffer(B, cfg_t.max_game_len)
    jaux = jl.make_aux(jax.random.PRNGKey(9), B)
    taux = tl.make_aux(B, raw_until=torch.tensor(np.array(jaux.raw_until)))
    assert bool((taux.raw_until > 20).any()) and bool((taux.raw_until <= 20).any())
    jtree = jt.make_tree(B, CAP)
    ttree = tt.make_tree(B, CAP)
    key = jax.random.PRNGKey(11)

    skipped = set()
    for ply in range(2):
        draws = _step_draws(key, b_sel)
        js, jbuf, jaux, jtree, key = j_step(js, jbuf, jaux, key,
                                            reuse_tree=jtree)
        ts, tbuf, taux, ttree = tl.selfplay_step_tiered(
            ts, tbuf, taux, t_eval, T_SEL, T_FAST, cfg_t, reuse_tree=ttree,
            reuse_capacity=CAP, draws=draws)
        t = int(np.asarray(js.move_count)[0]) - 1
        ties = _near_tie_boards(np.asarray(jbuf.pi)[:, t])
        if ties - skipped:
            print(f"ply {ply}: near-tie boards left out: {sorted(ties - skipped)}")
        skipped |= ties
        _compare(js, ts, skipped, "state")
        _compare(jbuf, tbuf, skipped, "buf")
        _compare(jaux, taux, skipped, "aux")
        _compare(jtree, ttree, skipped, "tree")
        pi = tbuf.pi[:, t]
        torch.testing.assert_close(pi.sum(-1), torch.ones(B), rtol=0, atol=1e-5)
    print(f"near-tie boards left out: {len(skipped)} of {B}")
    assert len(skipped) <= B // 2

    done = np.zeros(B, bool)
    done[[1, 6]] = True
    done |= np.asarray(jl.finished_mask(js, cfg_j))
    np.testing.assert_array_equal(tl.finished_mask(ts, cfg_t).numpy(),
                                  np.asarray(jl.finished_mask(js, cfg_j)))
    kreset = jax.random.PRNGKey(13)
    js, jbuf, jaux, jtree = jax.jit(functools.partial(
        jl.reset_finished, max_raw_policy_moves=30))(
            js, jbuf, jaux, jnp.asarray(done), cfg_j.komi, kreset,
            reuse_tree=jtree)
    ts, tbuf, taux, ttree = tl.reset_finished(
        ts, tbuf, taux, torch.from_numpy(done), cfg_t.komi,
        max_raw_policy_moves=30, reuse_tree=ttree,
        uniform=torch.tensor(np.array(jax.random.uniform(kreset, (B,)))))
    _compare(js, ts, skipped, "state")
    _compare(jbuf, tbuf, skipped, "buf")
    _compare(jaux, taux, skipped, "aux")
    _compare(jtree, ttree, skipped, "tree")


def test_tau_schedule_and_generator_draws():
    cfg = tl.SelfplayConfig()
    mc = np.array([0, 10, 40, 200], np.int32)
    np.testing.assert_allclose(
        tl.tau_schedule(torch.from_numpy(mc), cfg).numpy(),
        np.asarray(jl.tau_schedule(jnp.asarray(mc), jl.SelfplayConfig())),
        rtol=1e-6)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    d1 = tl.draw_step(8, cfg, g1, "cpu")
    d2 = tl.draw_step(8, cfg, g2, "cpu")
    for a, b in zip(d1, d2):
        assert torch.equal(a, b)
    assert d1.sel_noise.shape == (2, 362) and d1.fast_noise.shape == (6, 362)
