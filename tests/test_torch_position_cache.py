"""The port's PositionCache (p3achygo_tpu_torch/mcts/position_cache.py)
held against the JAX package's on the cases of tests/test_position_cache.py
and on the hashes of real boards."""
import numpy as np
import torch

from p3achygo_tpu.mcts.position_cache import PositionCache as JaxCache
from p3achygo_tpu_torch.game.board import legal_mask_batch, new_state, step
from p3achygo_tpu_torch.mcts.position_cache import PositionCache


def _stats(pc):
    return (pc.num_queries, pc.num_hits, pc.num_unique_positions_approx, pc.hit_rate,
            list(pc._cache.items()))


def test_insert_counts_and_stats():
    pc, jc = PositionCache(max_size=4), JaxCache(max_size=4)
    for h in (100, 100, 200, 100):
        assert pc.insert(h) == jc.insert(h)
    assert _stats(pc) == _stats(jc)
    assert (pc.num_queries, pc.num_hits, pc.num_unique_positions_approx) == (4, 2, 2)
    assert abs(pc.hit_rate - 0.5) < 1e-9 and PositionCache().hit_rate == 0.0


def test_lru_eviction_recounts_as_unique():
    pc, jc = PositionCache(max_size=2), JaxCache(max_size=2)
    for h in (1, 2, 3, 1, 3):
        assert pc.insert(h) == jc.insert(h)
    assert _stats(pc) == _stats(jc) and pc.num_unique_positions_approx == 4


def test_insert_batch_hash_lanes():
    lanes = np.array([[[1, 2]], [[1, 2]], [[3, 4]]], np.uint32)
    pc, jc = PositionCache(), JaxCache()
    got, want = pc.insert_batch(lanes), jc.insert_batch(lanes)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 1) and _stats(pc) == _stats(jc)
    # The port's int64 lanes (uint32 values) combine to the same keys.
    pc2 = PositionCache()
    np.testing.assert_array_equal(pc2.insert_batch(lanes.astype(np.int64)), want)
    assert _stats(pc2) == _stats(jc)


def test_real_selfplay_hashes():
    """Hashes of real boards: the port's int64 lanes, fed to the JAX cache
    as the uint32 lanes they hold."""
    t = new_state(6, device="cpu")
    g = torch.Generator().manual_seed(2)
    for _ in range(5):
        legal = legal_mask_batch(t)[:, :361]
        t, _ = step(t, torch.where(legal, torch.rand(legal.shape, generator=g), -1.0).argmax(1))
    lanes = torch.cat([t.hash, t.hash[:2]]).numpy()  # two repeats
    pc, jc = PositionCache(), JaxCache()
    got = pc.insert_batch(lanes)
    np.testing.assert_array_equal(got, jc.insert_batch(lanes.astype(np.uint32)))
    assert pc.num_hits == 2 and _stats(pc) == _stats(jc)
    # Fresh boards share one hash; different moves make unique positions.
    t = new_state(2, device="cpu")
    pc, jc = PositionCache(), JaxCache()
    pc.insert_batch(t.hash.numpy())
    jc.insert_batch(t.hash.numpy().astype(np.uint32))
    t, _ = step(t, torch.tensor([0, 1]))
    got = pc.insert_batch(t.hash.numpy())
    np.testing.assert_array_equal(got, jc.insert_batch(t.hash.numpy().astype(np.uint32)))
    assert (got == 1).all() and _stats(pc) == _stats(jc) and pc.num_hits == 1
