"""Grouped self-play tiers (SelfplayConfig.tier_groups) of the PyTorch port
held against the JAX package: selfplay_step_tiered at B=8 with 2 and 4
groups, two plies, a hash-keyed table evaluator and every JAX draw
injected. States, records and aux agree (integers exact, floats to 1e-5
relative), and each group runs exactly B_sel/G boards in the selected
tier, force_sel boards first."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.selfplay import loop as tl
from torch_parity import random_jax_states, state_to_torch, table_evals, tiered_step_draws, to_np

torch.set_num_threads(2)

B = 8
SEL = dict(n=4, k=2, max_depth=4)
FAST = dict(n=2, k=2, max_depth=4)


def _compare(jx, tx, what):
    for f in type(tx)._fields:
        a, b = to_np(getattr(jx, f)), getattr(tx, f).numpy()
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f"{what}.{f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_tiers_parity(groups):
    j_eval, t_eval = table_evals(groups)
    cfg_j = jl.SelfplayConfig(batch_size=B, max_game_len=24, tier_groups=groups)
    cfg_t = tl.SelfplayConfig(batch_size=B, max_game_len=24, tier_groups=groups)
    b_sel, b_fast = tl.tier_sizes(B, cfg_t)
    assert (b_sel, b_fast) == ((2, 6) if groups == 2 else (4, 4))
    j_step = jax.jit(functools.partial(
        jl.selfplay_step_tiered, eval_fn=j_eval, params_sel=jg.SearchParams(**SEL),
        params_fast=jg.SearchParams(**FAST), cfg=cfg_j))

    js = random_jax_states(B=B, moves=12, seed=groups, pass_prob=0.05)
    ts = state_to_torch(js)
    jbuf = jl.make_game_buffer(B, cfg_j.max_game_len)
    tbuf = tl.make_game_buffer(B, cfg_t.max_game_len, device="cpu")
    jaux = jl.make_aux(jax.random.PRNGKey(5), B)
    taux = tl.make_aux(B, raw_until=torch.tensor(np.array(jaux.raw_until)), device="cpu")
    key = jax.random.PRNGKey(17 + groups)
    Bg = B // groups
    for ply in range(2):
        # Ply 0: the last board of group 0 is forced into the selected tier.
        force = np.zeros(B, bool)
        force[Bg - 1] = ply == 0
        jaux = jaux._replace(force_sel=jnp.asarray(force))
        taux = taux._replace(force_sel=torch.from_numpy(force))
        draws = tiered_step_draws(key, B, b_sel)
        js, jbuf, jaux, key = j_step(js, jbuf, jaux, key)
        ts, tbuf, taux = tl.selfplay_step_tiered(
            ts, tbuf, taux, t_eval, tg.SearchParams(**SEL), tg.SearchParams(**FAST),
            cfg_t, draws=draws)
        _compare(js, ts, f"ply {ply} state")
        _compare(jbuf, tbuf, f"ply {ply} buf")
        _compare(jaux, taux, f"ply {ply} aux")

        t = int(np.asarray(js.move_count)[0]) - 1
        visits = tbuf.visits[:, t].reshape(groups, Bg)
        sel = visits > tg.visit_budget(tg.SearchParams(**FAST))
        assert (sel.sum(dim=1) == b_sel // groups).all(), visits
        if ply == 0:
            assert bool(sel[0, Bg - 1])


def test_tier_groups_checks():
    cfg = tl.SelfplayConfig(tier_groups=3)
    with pytest.raises(ValueError):
        tl.tier_sizes(8, cfg)  # 3 does not divide 8
    with pytest.raises(ValueError):
        tl.tier_sizes(3, cfg)  # one board per group: no room for two tiers
    with pytest.raises(ValueError):
        tl.tier_sizes(4, tl.SelfplayConfig(tier_groups=16))  # 4 groups of 1
    assert tl.tier_sizes(9, cfg) == (3, 6)
    assert tl.tier_sizes(6, cfg) == (3, 3)
    assert tl.tier_sizes(6, tl.SelfplayConfig(tier_groups=1)) == (2, 4)
