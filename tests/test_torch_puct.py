"""The PUCT search of the PyTorch port (p3achygo_tpu_torch/mcts/puct.py)
held against the JAX package's search_root_puct, and `strip_history`
against the JAX one: each root selection (visit count, LCB, a tempered
sample with the JAX draw injected), the variance scaling, PUCT-V and the
M3 bonus, exact terminal scoring and the integral utility, with
`return_tree` comparing the whole tree. The evaluation is the hash-keyed
table of tests/test_torch_search_extras.py (pass favoured, so searches
reach finished games). Integers exact; floats to tests/torch_parity.py's
tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.game.board import step as jax_step
from p3achygo_tpu.game.board import strip_history as jax_strip_history
from p3achygo_tpu.mcts import puct as jp
from p3achygo_tpu_torch.game.board import step, strip_history
from p3achygo_tpu_torch.mcts import puct as tp
from test_torch_search import _compare_result
from test_torch_search_extras import _endgame_states, _jax_eval, _pass_tables, _torch_eval
from torch_parity import assert_tree_equal, random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)


def test_strip_history_matches_jax():
    js = random_jax_states(B=3, moves=6, seed=1)
    ts = state_to_torch(js)
    jstrip = jax.vmap(jax_strip_history)(js)
    tstrip = strip_history(ts)
    assert tstrip.history.shape == (3, 0, 2) == jstrip.history.shape
    moves = np.array([0, 361, 200], np.int32)
    jn, _ = jax.jit(jax.vmap(jax_step))(jstrip, jnp.asarray(moves))
    tn, _ = step(tstrip, torch.from_numpy(moves))
    for f in tn._fields:
        np.testing.assert_array_equal(getattr(tn, f).numpy(), to_np(getattr(jn, f)), err_msg=f)


CASES = {
    "visit_count_var_scaling_exact_integral": dict(
        enable_var_scaling=True, terminal_mode="exact", score_utility_mode="integral"),
    "lcb_puct_v_m3": dict(root_selection="lcb", use_puct_v=True, enable_m3_bonus=True,
                          m3_prior_visits=2),
    "sample": dict(root_selection="sample", tau=0.7, root_fpu=0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_root_puct_matches_jax(case):
    B, seed = 4, 9
    kw = dict(n=12, max_depth=8, **CASES[case])
    tab = _pass_tables(seed)
    js = _endgame_states(B, seed)
    key = jax.random.PRNGKey(seed)
    jr, jtree = jax.jit(lambda k, s: jp.search_root_puct(
        k, s, functools.partial(_jax_eval, tab), jp.PuctParams(**kw), return_tree=True))(key, js)
    _, ks = jax.random.split(key)
    sample = torch.tensor(np.array(jax.random.gumbel(ks, (B, 362))))
    tr, ttree = tp.search_root_puct(state_to_torch(js), functools.partial(_torch_eval, tab),
                                    tp.PuctParams(**kw), return_tree=True, sample_gumbel=sample)
    _compare_result(jr, tr)
    assert_tree_equal(jtree, ttree)
    assert (tr.visits.numpy() == 12).all() and bool((ttree.is_terminal.any(dim=1)).any())
    # Without return_tree the search gives the same result alone.
    alone = tp.search_root_puct(state_to_torch(js), functools.partial(_torch_eval, tab),
                                tp.PuctParams(**kw), sample_gumbel=sample)
    np.testing.assert_array_equal(alone.mcts_move.numpy(), tr.mcts_move.numpy())


def test_puct_params_match_jax():
    import dataclasses
    assert dataclasses.asdict(tp.PuctParams()) == dataclasses.asdict(jp.PuctParams())
