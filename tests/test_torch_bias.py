"""The value-bias cache of the PyTorch port (p3achygo_tpu_torch/mcts/bias.py)
held against the JAX package: the pattern Zobrist tables, the pattern keys
of random boards, probe / fetch / accumulate with colliding slots and keys
>= 2**31, a search with the bias branch over two moves of tree reuse (the
trees' bias fields and the table after each move), and the tiered
self-play step and reset_finished carrying a table. Integers exact; floats
to 1e-5 relative (the table's sums run in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p3achygo_tpu.game.board import step as jax_step
from p3achygo_tpu.mcts import bias as jb
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.mcts import tree as jt
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu_torch.game.board import step as torch_step
from p3achygo_tpu_torch.mcts import bias as tb
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts import tree as tt
from p3achygo_tpu_torch.selfplay import loop as tl
from test_torch_search import _compare_result, _draws, _tables
from test_torch_search_extras import _jax_eval, _torch_eval
from test_torch_selfplay import _step_draws
from torch_parity import assert_tree_equal, random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

CAP = 24
RTOL = 1e-5


def assert_table_equal(jtab, ttab, what=""):
    for f in tb.BiasTable._fields:
        a, b = to_np(getattr(jtab, f)), getattr(ttab, f).numpy()
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6, err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {f}")


def test_pattern_tables_match_jax():
    for mine, theirs in ((tb._PZ, jb._PZ_GRID), (tb._PZ_ATARI, jb._PZ_ATARI),
                         (tb._PZ_KO, jb._PZ_KO)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    # The gather tables: the same rows, state 0 (never selected) zero.
    for mine, theirs in ((tb.PZ_GRID, jb._PZ_GRID), (tb.PZ_ATARI, jb._PZ_ATARI),
                         (tb.PZ_KO, jb._PZ_KO)):
        want = np.asarray(theirs).reshape(25, 4, 2).astype(np.int64)
        want[:, 0] = 0
        np.testing.assert_array_equal(mine.on("cpu").numpy(), want)
    assert (tb._PZ[:, :, 0] == 0).all() and (tb._PZ >= 1 << 31).any()


def _random_pattern_inputs(W, seed):
    rng = np.random.default_rng(seed)
    stones = rng.choice(np.array([0, 1, -1], np.int8), (W, 361), p=[0.5, 0.25, 0.25])
    atari = (stones != 0) & (rng.random((W, 361)) < 0.2)
    ill = (stones == 0) & (rng.random((W, 361)) < 0.1)
    last = rng.integers(-1, 362, (W, 5)).astype(np.int32)
    last[:8, -1] = [0, 18, 342, 360, 361, -1, 180, 20]  # corners, pass, noop
    last[8:12, -2] = -1
    to_move = rng.choice(np.array([1, -1], np.int8), W)
    return stones, atari, ill, last, to_move


def test_local_pattern_keys_match_jax():
    args = _random_pattern_inputs(64, 0)
    want = jb.local_pattern_keys(*map(jnp.asarray, args))
    got = tb.local_pattern_keys(*map(torch.from_numpy, args))
    for name, a, b in zip(("h0", "h1", "valid"), want, got):
        np.testing.assert_array_equal(b.numpy(), to_np(a), err_msg=name)
    assert (to_np(want[0]) >= 1 << 31).any() and to_np(want[2]).any() and not to_np(want[2]).all()


def test_probe_fetch_accumulate_match_jax():
    """Rounds of probe -> accumulate on a small table, where many nodes
    share slots (colliding keys: the last node in (board, node) order keeps
    its keys) and lanes both hit and miss."""
    rng = np.random.default_rng(1)
    B, S, k_r, N = 3, 16, 4, 10
    W = B * k_r
    jtab, ttab = jb.make_bias_table(B, S), tb.make_bias_table(B, S, device="cpu")
    keys = rng.integers(0, 1 << 32, (6, 2), dtype=np.uint64).astype(np.uint32)
    keys[0] |= np.uint32(1 << 31)
    for rnd in range(4):
        pick = rng.integers(0, 6, W)
        h0, h1 = keys[pick, 0], keys[pick, 1]
        valid = rng.random(W) < 0.85
        j = jb.bias_probe(jtab, k_r, jnp.asarray(h0), jnp.asarray(h1), jnp.asarray(valid))
        t = tb.bias_probe(ttab, k_r, torch.from_numpy(h0.astype(np.int64)),
                          torch.from_numpy(h1.astype(np.int64)), torch.from_numpy(valid))
        for name, a, b in zip(("num", "den", "slot", "can"), j, t):
            if name in ("num", "den"):
                np.testing.assert_allclose(b.numpy(), to_np(a), rtol=RTOL, atol=1e-6)
            else:
                np.testing.assert_array_equal(b.numpy(), to_np(a), err_msg=f"{rnd} {name}")
        fetch = tb.bias_fetch(ttab, k_r, torch.from_numpy(h0.astype(np.int64)),
                              torch.from_numpy(h1.astype(np.int64)), torch.from_numpy(valid), 0.35)
        np.testing.assert_allclose(fetch.numpy(), np.asarray(jb.bias_fetch(
            jtab, k_r, jnp.asarray(h0), jnp.asarray(h1), jnp.asarray(valid), 0.35)),
            rtol=RTOL, atol=1e-6)
        # Per-node accumulation: N nodes per board, slots from the probe's
        # lanes (duplicates) and random ones.
        slot_bn = np.concatenate([to_np(j[2]).reshape(B, k_r),
                                  rng.integers(0, S, (B, N - k_r))], axis=1).astype(np.int32)
        valid_bn = rng.random((B, N)) < 0.7
        kp = rng.integers(0, 6, (B, N))
        d_err = rng.normal(0, 1, (B, N)).astype(np.float32)
        d_w = rng.uniform(0, 3, (B, N)).astype(np.float32)
        jtab = jb.bias_accumulate(jtab, jnp.asarray(slot_bn), jnp.asarray(valid_bn),
                                  jnp.asarray(keys[kp, 0]), jnp.asarray(keys[kp, 1]),
                                  jnp.asarray(d_err), jnp.asarray(d_w))
        ttab = tb.bias_accumulate(ttab, torch.from_numpy(slot_bn), torch.from_numpy(valid_bn),
                                  torch.from_numpy(keys[kp, 0].astype(np.int64)),
                                  torch.from_numpy(keys[kp, 1].astype(np.int64)),
                                  torch.from_numpy(d_err), torch.from_numpy(d_w))
        assert_table_equal(jtab, ttab, f"round {rnd}")
    assert int(ttab.used.sum()) > B and bool(t[0].abs().sum() > 0)


@functools.lru_cache(maxsize=None)
def _jax_bias_search(params, seed):
    ev = functools.partial(_jax_eval, _tables(seed))

    @jax.jit
    def run(key, states, init_tree, table):
        return jg.search_root(key, states, ev, params, init_tree=init_tree,
                              reuse_capacity=CAP, bias_table=table)
    return run


def test_bias_search_under_tree_reuse_matches_jax():
    """Three searches with reuse: the first fills the table, later ones
    correct fresh leaves by it and accumulate deltas against the reused
    nodes' last contributions."""
    B, seed = 4, 3
    kw = dict(n=16, k=4, max_depth=8, visit_group=2, bias_lambda=0.35, bias_alpha=0.8)
    run = _jax_bias_search(jg.SearchParams(**kw), seed)
    tp = tg.SearchParams(**kw)
    t_eval = functools.partial(_torch_eval, _tables(seed))
    js = random_jax_states(B=B, moves=20, seed=seed)
    ts = state_to_torch(js)
    jtree, ttree = jt.make_tree(B, CAP), tt.make_tree(B, CAP, device="cpu")
    jtab, ttab = jb.make_bias_table(B, 256), tb.make_bias_table(B, 256, device="cpu")
    key = jax.random.PRNGKey(seed)
    for move_no in range(3):
        key, ks = jax.random.split(key)
        noise, _ = _draws(ks, B)
        jr, jwork, jtab = run(ks, js, jtree, jtab)
        tr, twork, ttab = tg.search_root(ts, t_eval, tp, init_tree=ttree, reuse_capacity=CAP,
                                         gumbel_noise=torch.from_numpy(noise), bias_table=ttab)
        _compare_result(jr, tr)
        assert_tree_equal(jwork, twork)
        assert_table_equal(jtab, ttab, f"move {move_no}")
        move = np.array(jr.mcts_move)
        jtree = jax.jit(jt.compact_subtree, static_argnums=2)(jwork, jnp.asarray(move), CAP)
        ttree = tt.compact_subtree(twork, torch.from_numpy(move), CAP)
        assert_tree_equal(jtree, ttree)
        js, _ = jax.jit(jax.vmap(jax_step))(js, jnp.asarray(move))
        ts, _ = torch_step(ts, torch.from_numpy(move))
    assert int(ttab.used.sum()) > 0 and bool((ttree.bias_slot >= 0).any())
    assert bool((ttree.bias_w_last > 0).any())


def test_tiered_step_and_reset_with_bias_match_jax():
    B = 8  # test_torch_selfplay's _step_draws batch
    seed = 2
    j_sel = jg.SearchParams(n=8, k=2, max_depth=6, bias_lambda=0.35)
    j_fast = jg.SearchParams(n=4, k=2, max_depth=6, bias_lambda=0.35)
    t_sel = tg.SearchParams(n=8, k=2, max_depth=6, bias_lambda=0.35)
    t_fast = tg.SearchParams(n=4, k=2, max_depth=6, bias_lambda=0.35)
    cfg_j, cfg_t = jl.SelfplayConfig(batch_size=B), tl.SelfplayConfig(batch_size=B)
    b_sel, _ = tl.tier_sizes(B, cfg_t)
    j_step = jax.jit(functools.partial(
        jl.selfplay_step_tiered, eval_fn=functools.partial(_jax_eval, _tables(seed)),
        params_sel=j_sel, params_fast=j_fast, cfg=cfg_j, reuse_capacity=CAP))
    t_eval = functools.partial(_torch_eval, _tables(seed))
    js = random_jax_states(B=B, moves=16, seed=seed)
    ts = state_to_torch(js)
    jbuf = jl.make_game_buffer(B, cfg_j.max_game_len)
    tbuf = tl.make_game_buffer(B, cfg_t.max_game_len, device="cpu")
    jaux = jl.make_aux(jax.random.PRNGKey(9), B)
    taux = tl.make_aux(B, raw_until=torch.tensor(np.array(jaux.raw_until)), device="cpu")
    jtree, ttree = jt.make_tree(B, CAP), tt.make_tree(B, CAP, device="cpu")
    jtab, ttab = jb.make_bias_table(B, 128), tb.make_bias_table(B, 128, device="cpu")
    key = jax.random.PRNGKey(4)
    for ply in range(2):
        draws = _step_draws(key, b_sel)
        js, jbuf, jaux, jtree, jtab, key = j_step(js, jbuf, jaux, key, reuse_tree=jtree,
                                                  bias_table=jtab)
        ts, tbuf, taux, ttree, ttab = tl.selfplay_step_tiered(
            ts, tbuf, taux, t_eval, t_sel, t_fast, cfg_t, reuse_tree=ttree,
            reuse_capacity=CAP, draws=draws, bias_table=ttab)
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(), to_np(getattr(js, f)),
                                          err_msg=f"ply {ply} {f}")
        assert_tree_equal(jtree, ttree)
        assert_table_equal(jtab, ttab, f"ply {ply}")
    assert int(ttab.used.sum()) > 0
    done = np.zeros(B, bool)
    done[[0, 5]] = True
    kreset = jax.random.PRNGKey(13)
    out_j = jl.reset_finished(js, jbuf, jaux, jnp.asarray(done), cfg_j.komi, kreset,
                              reuse_tree=jtree, bias_table=jtab)
    out_t = tl.reset_finished(ts, tbuf, taux, torch.from_numpy(done), cfg_t.komi,
                              reuse_tree=ttree, bias_table=ttab,
                              uniform=torch.tensor(np.array(jax.random.uniform(kreset, (B,)))))
    assert len(out_j) == len(out_t) == 5
    assert_tree_equal(out_j[3], out_t[3])
    assert_table_equal(out_j[4], out_t[4], "reset")
    assert int(out_t[4].used[done].sum()) == 0 and int(out_t[4].used[~done].sum()) > 0
    # Without a tree the table comes fourth.
    only = tl.reset_finished(ts, tbuf, taux, torch.from_numpy(done), cfg_t.komi,
                             bias_table=ttab, uniform=torch.zeros(B))
    assert len(only) == 4 and isinstance(only[3], tb.BiasTable)
