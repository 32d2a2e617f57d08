"""MCGS of the PyTorch port held against the JAX package: the
transposition table's probe and insert with forced slot collisions and
keys >= 2**31 (colliding inserts keep the last lane, as XLA:CPU's scatter
does), and whole searches with `use_mcgs` over two moves of tree reuse,
whose working and compacted trees must be equal (integers exact, floats to
tests/torch_parity.py's tolerance). The evaluation is a hash-keyed table
whose priors favour five points, so descents transpose."""
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
from test_torch_search import _compare_result, _draws, _tables
from test_torch_search_extras import _jax_eval, _torch_eval
from torch_parity import assert_tree_equal, random_jax_states, state_to_torch, to_np

torch.set_num_threads(2)

CAP = 40
FAVOURED = (100, 102, 140, 142, 180)


def _peaked_tables(seed):
    tab = _tables(seed)
    logits = tab["logp"].astype(np.float64)
    logits[:, list(FAVOURED)] += 10.0
    tab["logp"] = (logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
                   ).astype(np.float32)
    return tab


def _colliding_keys(rng, S, n):
    """n (h0, h1) pairs with bit 31 set that all hash to one base slot:
    h0's low bits cancel those of h1 * 2654435761."""
    h1 = rng.integers(1 << 31, 1 << 32, n, dtype=np.uint64)
    mixed = (h1 * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    target = np.uint64(rng.integers(0, S))
    high = rng.integers(0, 1 << 32, n, dtype=np.uint64) | np.uint64(1 << 31)
    h0 = (high & ~np.uint64(S - 1)) | ((mixed ^ target) & np.uint64(S - 1))
    return h0.astype(np.uint32), h1.astype(np.uint32)


def test_probe_and_insert_with_collisions_match_jax():
    rng = np.random.default_rng(0)
    B, S, k_r = 3, 16, 4
    W = B * k_r
    h0, h1 = _colliding_keys(rng, S, W)
    assert (h0 >= 1 << 31).all() and (h1 >= 1 << 31).all()
    meta = rng.choice(np.array([1, -1, 2, -2], np.int8), W)
    jtab, ttab = jt.make_mcgs_table(B, S), tt.make_mcgs_table(B, S, "cpu")
    ti = lambda a: torch.from_numpy(a.astype(np.int64))
    saw_full = False
    for rnd in range(8):
        do = rng.random(W) < 0.8
        node = rng.integers(1, 30, W).astype(np.int32)
        jhit, jnode, jslot, jempty = jt.mcgs_probe(jtab, k_r, jnp.asarray(h0), jnp.asarray(h1),
                                                  jnp.asarray(meta))
        thit, tnode, tslot, tempty = tt.mcgs_probe(ttab, k_r, ti(h0), ti(h1),
                                                   torch.from_numpy(meta))
        saw_full |= not bool(tempty.all())  # a full probe window: no empty slot
        for name, a, b in (("hit", jhit, thit), ("node", jnode, tnode),
                           ("slot", jslot, tslot), ("empty", jempty, tempty)):
            np.testing.assert_array_equal(b.numpy(), to_np(a), err_msg=f"round {rnd} {name}")
        # Every lane of a board inserts at its (shared) first empty slot:
        # the last lane of each board must win.
        jtab = jt.mcgs_insert(jtab, k_r, jslot, jnp.asarray(h0), jnp.asarray(h1),
                              jnp.asarray(meta), jnp.asarray(node), jnp.asarray(do & to_np(jempty)))
        tt.mcgs_insert(ttab, k_r, tslot, ti(h0), ti(h1), torch.from_numpy(meta),
                       torch.from_numpy(node), torch.from_numpy(do) & tempty)
        for f in tt.McgsTable._fields:
            np.testing.assert_array_equal(getattr(ttab, f).numpy(), to_np(getattr(jtab, f)),
                                          err_msg=f"round {rnd} {f}")
        h0 = np.where(rng.random(W) < 0.5, h0, np.roll(h0, 1))  # some lanes now hit
    assert int((ttab.meta != 0).sum()) > B and bool(thit.any()) and saw_full


def test_mcgs_meta_and_slots_match_jax():
    rng = np.random.default_rng(1)
    h0 = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    h1 = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        tt._mcgs_slots(torch.from_numpy(h0.astype(np.int64)),
                       torch.from_numpy(h1.astype(np.int64)), 256).numpy(),
        np.asarray(jt._mcgs_slots(jnp.asarray(h0), jnp.asarray(h1), 256)))
    color = np.array([1, -1, 1, -1], np.int8)
    term = np.array([False, False, True, True])
    np.testing.assert_array_equal(
        tt.mcgs_meta(torch.from_numpy(color), torch.from_numpy(term)).numpy(),
        np.asarray(jt.mcgs_meta(jnp.asarray(color), jnp.asarray(term))))
    a = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001, 123456789], dtype=torch.int64)
    for c in (2654435761, 2246822519, 3266489917, 7):
        want = (a.numpy().astype(object) * c) % (1 << 32)
        np.testing.assert_array_equal(tt.mul_u32(a, c).numpy(), want.astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_search(params, seed):
    ev = functools.partial(_jax_eval, _peaked_tables(seed))

    @jax.jit
    def run(key, states, init_tree):
        return jg.search_root(key, states, ev, params, init_tree=init_tree,
                              reuse_capacity=CAP)
    return run


@pytest.mark.parametrize("g", [1, 2])
def test_mcgs_search_and_reuse_match_jax(g):
    """Two moves with tree reuse; the compaction under MCGS keeps the JAX
    one's nodes (those whose first allocation parent is kept) and rebuilds
    children the same way, duplicate nodes of one sweep included."""
    B, seed = 4, 5
    kw = dict(n=16, k=2, max_depth=10, visit_group=g, use_mcgs=True, noise_scale=0.3)
    run = _jax_search(jg.SearchParams(**kw), seed)
    tp = tg.SearchParams(**kw)
    t_eval = functools.partial(_torch_eval, _peaked_tables(seed))
    js = random_jax_states(B=B, moves=12, seed=seed)
    ts = state_to_torch(js)
    jtree, ttree = jt.make_tree(B, CAP), tt.make_tree(B, CAP, device="cpu")
    key = jax.random.PRNGKey(seed)
    tg.COUNTERS.reset()
    for _ in range(2):
        key, ks = jax.random.split(key)
        noise, _ = _draws(ks, B)
        jr, jwork = run(ks, js, jtree)
        tr, twork = tg.search_root(ts, t_eval, tp, init_tree=ttree, reuse_capacity=CAP,
                                   gumbel_noise=torch.from_numpy(noise))
        _compare_result(jr, tr)
        assert_tree_equal(jwork, twork)
        move = np.array(jr.mcts_move)
        jtree = jax.jit(jt.compact_subtree, static_argnums=2)(jwork, jnp.asarray(move), CAP)
        ttree = tt.compact_subtree(twork, torch.from_numpy(move), CAP)
        assert_tree_equal(jtree, ttree)
        js, _ = jax.jit(jax.vmap(jax_step))(js, jnp.asarray(move))
        ts, _ = torch_step(ts, torch.from_numpy(move))
    assert tg.COUNTERS.snapshot()["mcgs_hits"] > 0
