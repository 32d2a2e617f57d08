"""The search extras of the PyTorch port held against the JAX package: the
integral score utility, the Student-t table and the early-stopping check,
and whole searches with early stopping or over-search, exact terminal
scoring and the integral utility, over two moves of tree reuse. The JAX
Gumbel draws are injected and the evaluation is the hash-keyed table of
tests/test_torch_search.py; moves, visit counts and `visits_spent` exact,
trees to tests/torch_parity.py's tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game.board import from_stones as jax_from_stones
from p3achygo_tpu.game.board import step as jax_step
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.mcts import tree as jt
from p3achygo_tpu_torch.game.board import step as torch_step
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts import tree as tt
from test_torch_search import _compare_result, _draws, _tables
from torch_parity import assert_tree_equal, random_jax_states, state_to_torch

torch.set_num_threads(2)

CAP = 40
T = 251
PASS_BOOST = 4.0  # extra pass logit: searches reach finished games


def _pass_tables(seed):
    tab = _tables(seed)
    logits = tab["logp"].astype(np.float64)
    logits[:, 361] += PASS_BOOST
    tab["logp"] = (logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
                   ).astype(np.float32)
    return tab


def _jax_eval(tab, states):
    idx = (states.hash[:, 0] % T).astype(jnp.int32)
    return jg.EvalOutput(log_priors=jnp.asarray(tab["logp"])[idx],
                         outcome_value=jnp.asarray(tab["v"])[idx],
                         score_est=jnp.asarray(tab["score"])[idx],
                         score_var=jnp.asarray(tab["var"])[idx],
                         err_est=jnp.asarray(tab["err"])[idx])


def _torch_eval(tab, states):
    idx = states.hash[:, 0] % T
    t = {k: torch.from_numpy(v) for k, v in tab.items()}
    return tg.EvalOutput(log_priors=t["logp"][idx], outcome_value=t["v"][idx],
                         score_est=t["score"][idx], score_var=t["var"][idx],
                         err_est=t["err"][idx])


def test_integral_score_utility_matches_jax():
    rng = np.random.default_rng(0)
    est = rng.normal(0, 30, 257).astype(np.float32)
    std = np.abs(rng.normal(0, 15, 257)).astype(np.float32)
    std[:9] = 0.0  # terminal utilities use stddev 0
    root = rng.normal(0, 20, 257).astype(np.float32)
    want = np.asarray(jg._score_utility_integral(0.5, est, std, root))
    got = tg._score_utility_integral(0.5, *map(torch.from_numpy, (est, std, root)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    for mode in ("direct", "integral"):
        jp = jg.SearchParams(score_utility_mode=mode, score_weight=0.3)
        tp = tg.SearchParams(score_utility_mode=mode, score_weight=0.3)
        var = std ** 2
        np.testing.assert_allclose(
            tg._leaf_score_utility(tp, *map(torch.from_numpy, (est, var, root))).numpy(),
            np.asarray(jg._leaf_score_utility(jp, est, var, root)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("alpha", [0.05, 1 - 0.95 ** 0.5 / 2, 0.3])
def test_t_quantile_table_matches_jax(alpha):
    want = np.asarray(jg._t_quantile_table(alpha))
    got = tg._t_quantile_table(alpha).numpy()
    assert got.shape == want.shape == (512,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_can_stop_early_matches_jax():
    """The check on worked trees with many visits per candidate: random
    edge stats over the root's first 8 actions, ties in the score order."""
    rng = np.random.default_rng(3)
    B, N, k = 6, 12, 4
    jtree = jt.make_tree(B, N)
    en = np.zeros((B, N, 362), np.int16)
    ew = np.zeros((B, N, 362), np.float32)
    ch = np.full((B, N, 362), -1, np.int16)
    en[:, 0, :8] = rng.integers(0, 40, (B, 8))
    ew[:, 0, :8] = en[:, 0, :8] * rng.uniform(-0.8, 0.8, (B, 8))
    ch[:, 0, :8] = np.where(en[:, 0, :8] > 0, np.arange(1, 9), -1)
    vvar = rng.uniform(0, 3, (B, N)).astype(np.float32)
    jtree = jtree._replace(edge_n=jnp.asarray(en), edge_w=jnp.asarray(ew),
                           children=jnp.asarray(ch), v_var_sum=jnp.asarray(vvar))
    ttree = tt.make_tree(B, N, "cpu")._replace(
        edge_n=torch.from_numpy(en), edge_w=torch.from_numpy(ew),
        children=torch.from_numpy(ch), v_var_sum=torch.from_numpy(vvar))
    cand = np.stack([rng.permutation(8)[:k] for _ in range(B)]).astype(np.int32)
    valid = rng.random((B, k)) < 0.9
    base = rng.normal(0, 1, (B, 362)).astype(np.float32)
    base[0, cand[0]] = 0.0  # equal scores: the lower index ranks first
    params = dict(c_visit=50.0, c_scale=0.001)
    ztab = np.array(jg._t_quantile_table(0.1))
    check = jax.jit(jg._can_stop_early, static_argnums=(3, 6))
    seen = []
    for k_r in (4, 2):
        want = np.asarray(check(jtree, jnp.asarray(cand), jnp.asarray(valid), k_r,
                                jnp.asarray(base), jnp.asarray(ztab),
                                jg.SearchParams(**params)))
        got = tg._can_stop_early(ttree, torch.from_numpy(cand).long(), torch.from_numpy(valid),
                                 k_r, torch.from_numpy(base), torch.from_numpy(ztab),
                                 tg.SearchParams(**params))
        np.testing.assert_array_equal(got.numpy(), want)
        seen.append(want)
    assert np.concatenate(seen).any() and not np.concatenate(seen).all()


@functools.lru_cache(maxsize=None)
def _jax_search(params, seed):
    ev = functools.partial(_jax_eval, _pass_tables(seed))

    @jax.jit
    def run(key, states, tau, init_tree):
        return jg.search_root(key, states, ev, params, tau=tau, init_tree=init_tree,
                              reuse_capacity=CAP)
    return run


def _endgame_states(B, seed):
    """Boards one pass from the end: random play, then a pass, plus one
    settled board built with from_stones (two walls, no dame)."""
    js = random_jax_states(B=B - 1, moves=40, seed=seed)
    js, _ = jax.jit(jax.vmap(jax_step))(js, jnp.full((B - 1,), 361, jnp.int32))
    settled = np.zeros(361, np.int8)
    settled.reshape(19, 19)[:, 8] = 1
    settled.reshape(19, 19)[:, 10] = -1
    one = jax_from_stones(jnp.asarray(settled), 7.5, 1)
    one, _ = jax_step(one, jnp.int32(361))
    return jax.tree_util.tree_map(lambda a, o: jnp.concatenate([a, o[None]]), js, one)


def _run_two_moves(jp, tp, js, seed, tau):
    B = js.stones.shape[0]
    run = _jax_search(jp, seed)
    t_eval = functools.partial(_torch_eval, _pass_tables(seed))
    ts = state_to_torch(js)
    jtree, ttree = jt.make_tree(B, CAP), tt.make_tree(B, CAP, device="cpu")
    key = jax.random.PRNGKey(seed)
    visits = []
    for _ in range(2):
        key, ks = jax.random.split(key)
        noise, sample = _draws(ks, B)
        jr, jwork = run(ks, js, jnp.asarray(tau), jtree)
        tr, twork = tg.search_root(ts, t_eval, tp, tau=torch.from_numpy(tau),
                                   init_tree=ttree, reuse_capacity=CAP,
                                   gumbel_noise=torch.from_numpy(noise),
                                   sample_gumbel=torch.from_numpy(sample))
        _compare_result(jr, tr)
        assert_tree_equal(jwork, twork)
        visits.append(tr.visits.numpy())
        move = np.array(jr.mcts_move)
        jtree = jax.jit(jt.compact_subtree, static_argnums=2)(jwork, jnp.asarray(move), CAP)
        ttree = tt.compact_subtree(twork, torch.from_numpy(move), CAP)
        assert_tree_equal(jtree, ttree)
        js, _ = jax.jit(jax.vmap(jax_step))(js, jnp.asarray(move))
        ts, _ = torch_step(ts, torch.from_numpy(move))
    return visits


def test_early_stopping_exact_terminals_integral_match_jax():
    """Early stopping with grouped visits (g=2: the last sweep of a round
    may overshoot), exact Benson scoring of terminal leaves and the
    integral utility, on boards one pass from the end."""
    B, seed = 5, 7
    kw = dict(n=16, k=4, max_depth=8, visit_group=2, early_stopping=True,
              terminal_mode="exact", score_utility_mode="integral")
    js = _endgame_states(B, seed)
    tg.COUNTERS.reset()
    visits = _run_two_moves(jg.SearchParams(**kw), tg.SearchParams(**kw), js, seed,
                            np.array([0.7, 0.0, 0.3, 0.0, 1.0], np.float32))
    snap = tg.COUNTERS.snapshot()
    assert snap["exact_scored"] > 0, snap
    assert snap["syncs"]["early_stop"] > 0 and snap["syncs"]["exact_terminal"] > 0
    # visits_spent stays within the schedule's allocation (16 + overshoot).
    assert all((v <= 16 + 4).all() for v in visits)


def test_over_search_matches_jax():
    """Over-search (budget 2.5x, checks from v_r on): boards stop early."""
    B, seed = 4, 11
    kw = dict(n=16, k=2, max_depth=8, over_search=True, c_scale=0.01)
    js = random_jax_states(B=B, moves=30, seed=seed, pass_prob=0.05)
    tg.COUNTERS.reset()
    visits = _run_two_moves(jg.SearchParams(**kw), tg.SearchParams(**kw), js, seed,
                            np.zeros(B, np.float32))
    assert tg.COUNTERS.snapshot()["early_stops"] > 0
    v = np.concatenate(visits)
    assert (v < 40).any() and (v <= 40).all(), v
