"""Gumbel search of the PyTorch port held against the JAX package: the JAX
Gumbel draws are injected, the evaluation is deterministic (the uniform
eval, or a hash-keyed table eval written identically for both), and the
whole working tree and result are compared after a search, after
compact_subtree and after a second search on the reused tree. Integers
exact; floats to 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game.board import step as jax_step
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.mcts import tree as jt
from p3achygo_tpu_torch.game.board import step as torch_step
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts import tree as tt
from torch_parity import assert_tree_equal, random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

CAP = 24
T = 251  # table rows; index = hash lane 0 mod T


def _tables(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, size=(T, 362))
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return dict(logp=logp.astype(np.float32),
                v=rng.uniform(-0.9, 0.9, T).astype(np.float32),
                score=rng.normal(0, 10, T).astype(np.float32),
                var=rng.uniform(0, 50, T).astype(np.float32),
                err=rng.uniform(0, 0.5, T).astype(np.float32))


def jax_table_eval(tab, states):
    idx = (states.hash[:, 0] % T).astype(jnp.int32)
    return jg.EvalOutput(log_priors=jnp.asarray(tab["logp"])[idx],
                         outcome_value=jnp.asarray(tab["v"])[idx],
                         score_est=jnp.asarray(tab["score"])[idx],
                         score_var=jnp.asarray(tab["var"])[idx],
                         err_est=jnp.asarray(tab["err"])[idx])


def torch_table_eval(tab, states):
    idx = states.hash[:, 0] % T
    t = {k: torch.from_numpy(v) for k, v in tab.items()}
    return tg.EvalOutput(log_priors=t["logp"][idx], outcome_value=t["v"][idx],
                         score_est=t["score"][idx], score_var=t["var"][idx],
                         err_est=t["err"][idx])


def _draws(key, B):
    """The two Gumbel draws of jax search_root for `key` (gumbel.py:850-851,
    1579-1584)."""
    k1, knoise = jax.random.split(key)
    _, ksample = jax.random.split(k1)
    return (np.array(jax.random.gumbel(knoise, (B, 362))),
            np.array(jax.random.gumbel(ksample, (B, 362))))


@functools.lru_cache(maxsize=None)
def _jax_search(params, eval_name, seed):
    tab = _tables(seed)
    ev = jg.uniform_eval_fn if eval_name == "uniform" else \
        functools.partial(jax_table_eval, tab)

    @jax.jit
    def run(key, states, tau, init_tree):
        return jg.search_root(key, states, ev, params, tau=tau,
                              init_tree=init_tree, reuse_capacity=CAP)
    return run


def _torch_eval(eval_name, seed):
    return tg.uniform_eval_fn if eval_name == "uniform" else \
        functools.partial(torch_table_eval, _tables(seed))


def _compare_result(jr, tr):
    for f in ("mcts_move", "raw_nn_move", "visits", "root_child_visits",
              "root_value_dist"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      to_np(getattr(jr, f)), err_msg=f)
    for f in ("pi_improved", "root_value", "root_outcome", "root_score_est",
              "q_selected", "qz_selected", "kld", "root_priors", "root_child_q"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), to_np(getattr(jr, f)),
                                   rtol=0, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("eval_name,g", [("uniform", 2), ("table", 2),
                                         ("table", 1)])
def test_search_reuse_compact_parity(eval_name, g):
    B, seed = 3, 4
    params = jg.SearchParams(n=16, k=4, max_depth=8, visit_group=g)
    tparams = tg.SearchParams(n=16, k=4, max_depth=8, visit_group=g)
    run = _jax_search(params, eval_name, seed)
    t_eval = _torch_eval(eval_name, seed)

    js = random_jax_states(B=B, moves=30, seed=seed, pass_prob=0.05)
    ts = state_to_torch(js)
    jtree = jt.make_tree(B, CAP)
    ttree = tt.make_tree(B, CAP, device="cpu")
    tau = np.array([0.8, 0.0, 0.3], np.float32)
    key = jax.random.PRNGKey(seed)
    for move_no in range(2):
        key, ks = jax.random.split(key)
        noise, sample = _draws(ks, B)
        jr, jwork = run(ks, js, jnp.asarray(tau), jtree)
        tr, twork = tg.search_root(ts, t_eval, tparams, tau=torch.from_numpy(tau),
                                   init_tree=ttree, reuse_capacity=CAP,
                                   gumbel_noise=torch.from_numpy(noise),
                                   sample_gumbel=torch.from_numpy(sample))
        _compare_result(jr, tr)
        assert_tree_equal(jwork, twork)
        move = np.array(jr.mcts_move)
        jtree = jax.jit(jt.compact_subtree, static_argnums=2)(
            jwork, jnp.asarray(move), CAP)
        ttree = tt.compact_subtree(twork, torch.from_numpy(move), CAP)
        assert_tree_equal(jtree, ttree)
        js, _ = jax.jit(jax.vmap(jax_step))(js, jnp.asarray(move))
        ts, _ = torch_step(ts, torch.from_numpy(move))


def test_fresh_search_without_tree_and_pre_stats():
    """search_root without init_tree returns only the result; root_pre_stats
    of a searched tree agree."""
    B, seed = 2, 8
    params = jg.SearchParams(n=8, k=2, max_depth=6, visit_group=2, tau=0.0)
    tparams = tg.SearchParams(n=8, k=2, max_depth=6, visit_group=2, tau=0.0)
    js = random_jax_states(B=B, moves=12, seed=seed)
    ts = state_to_torch(js)
    key = jax.random.PRNGKey(1)
    noise, _ = _draws(key, B)
    ev = functools.partial(jax_table_eval, _tables(seed))
    jr, jwork = jax.jit(lambda k, s, tr: jg.search_root(
        k, s, ev, params, init_tree=tr, reuse_capacity=CAP))(
            key, js, jt.make_tree(B, CAP))
    tr = tg.search_root(ts, _torch_eval("table", seed), tparams,
                        gumbel_noise=torch.from_numpy(noise))
    assert isinstance(tr, tg.GumbelResult)
    _compare_result(jr, tr)
    _, twork = tg.search_root(ts, _torch_eval("table", seed), tparams,
                              init_tree=tt.make_tree(B, CAP, device="cpu"), reuse_capacity=CAP,
                              gumbel_noise=torch.from_numpy(noise))
    jp = jg.root_pre_stats(jwork)
    tp = tg.root_pre_stats(twork)
    for f in tg.RootPreStats._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(), to_np(getattr(jp, f)),
                                   rtol=0, atol=1e-5, err_msg=f)


def test_compact_root_parity():
    B = 2
    params = jg.SearchParams(n=8, k=2, max_depth=6)
    js = random_jax_states(B=B, moves=5, seed=3)
    key = jax.random.PRNGKey(2)
    noise, _ = _draws(key, B)
    _, jwork = jax.jit(lambda k, s, tr: jg.search_root(
        k, s, jg.uniform_eval_fn, params, init_tree=tr, reuse_capacity=CAP))(
            key, js, jt.make_tree(B, CAP))
    twork = tt.compact_root(
        tg.search_root(state_to_torch(js), tg.uniform_eval_fn,
                       tg.SearchParams(n=8, k=2, max_depth=6),
                       init_tree=tt.make_tree(B, CAP, device="cpu"), reuse_capacity=CAP,
                       gumbel_noise=torch.from_numpy(noise))[1], 12)
    assert_tree_equal(jax.jit(jt.compact_root, static_argnums=1)(jwork, 12), twork)


@pytest.mark.parametrize("option", ["use_mcgs", "early_stopping", "over_search",
                                    "bias_lambda", "terminal_mode",
                                    "score_utility_mode"])
def test_unported_options_raise(option):
    value = {"bias_lambda": 0.5, "terminal_mode": "exact",
             "score_utility_mode": "integral"}.get(option, True)
    params = tg.SearchParams(n=4, k=2, **{option: value})
    ts = state_to_torch(random_jax_states(B=1, moves=2, seed=0))
    with pytest.raises(NotImplementedError):
        tg.search_root(ts, tg.uniform_eval_fn, params,
                       generator=torch.Generator().manual_seed(0))


def test_saturating_edge_add():
    en = torch.tensor([0, 100, tt.EDGE_N_MAX - 1], dtype=torch.int16)
    out = tt.saturating_edge_add(en, torch.tensor([5.0, 7.0, 9.0]))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jt.saturating_edge_add(
            jnp.asarray(en.numpy()), jnp.asarray([5.0, 7.0, 9.0]))))
    assert out.dtype == torch.int16
