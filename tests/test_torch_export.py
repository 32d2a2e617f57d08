"""The port's chunk exporter (data/export.py) held against the JAX
package's: one seeded game from random legal play (so the atari, two- and
three-liberty planes are not empty) gives the same Example bytes record
by record, a chunk either package wrote reads back the same in both, and
records_to_examples keeps JAX's reconstruction rules."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from p3achygo_tpu.data import export as jexp
from p3achygo_tpu.selfplay.records import GameExamples as JaxGameExamples
from p3achygo_tpu_torch.data import export as texp
from p3achygo_tpu_torch.data.tfrecord import read_records
from p3achygo_tpu_torch.ops.liberties import point_liberties_reference
from p3achygo_tpu_torch.game.board import compute_chains
from p3achygo_tpu_torch.selfplay.records import GameExamples
from torch_parity import random_jax_states, to_np

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def game():
    """Column dict of one seeded 12-move game (positions after 0..55 plies
    of random legal play, alternating colours, komi 7.5)."""
    M = 12
    rng = np.random.default_rng(0)
    stones = np.concatenate([to_np(random_jax_states(4, plies, 1 + plies).stones)
                             for plies in (0, 20, 40)])[:M].astype(np.int8)
    margin = (rng.normal(0, 10, M) + 0.5).astype(np.float32)
    pad = rng.random((M, 362)).astype(np.float32)
    pad[::3] = 0.0
    f32 = lambda: rng.normal(size=M).astype(np.float32)
    return dict(
        stones=stones, last_moves=rng.integers(-1, 362, (M, 5)).astype(np.int16),
        color=np.tile(np.array([1, -1], np.int8), M // 2),
        komi=np.full(M, 7.5, np.float32),
        pi=rng.dirichlet(np.ones(362), M).astype(np.float32),
        pi_aux=rng.integers(0, 362, M).astype(np.int16), pi_aux_dist=pad,
        has_pi_aux_dist=pad.any(-1), own=rng.integers(-1, 2, (M, 361)).astype(np.int8),
        score_margin=margin, z=np.where(margin > 0, 1.0, -1.0).astype(np.float32),
        q6=f32(), q16=f32(), q50=f32(), q6_score=f32(), q16_score=f32(), q50_score=f32(),
        weight=np.ones(M, np.float32),
        mcts_value_dist=rng.integers(0, 9, (M, 51)).astype(np.uint16))


def _assert_examples_equal(a, b):
    for f in dataclasses.fields(GameExamples):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_records_match_jax(game):
    recs = texp.examples_to_records(GameExamples(**game), device="cpu")
    assert recs == jexp.examples_to_records(JaxGameExamples(**game))
    libs = texp.liberty_planes(game["stones"], device="cpu")
    s = torch.from_numpy(game["stones"])
    np.testing.assert_array_equal(libs, point_liberties_reference(s, compute_chains(s)))
    assert ((libs == 1) & (game["stones"] != 0)).any()


def test_chunks_cross_read(game, tmp_path):
    """A chunk JAX wrote reads back in the port as the port's own decoding
    of its records, and the other way round; the decoded examples keep the
    stored fields and rebuild z, weight and has_pi_aux_dist."""
    jpath = jexp.write_game_chunk(str(tmp_path / "jax"), [JaxGameExamples(**game)], gen=3)
    tpath = texp.write_game_chunk(str(tmp_path / "port"), [GameExamples(**game)] * 2,
                                  gen=3, batch_id=5, worker_id="wA", device="cpu")
    from_jax = texp.read_game_chunk(jpath)
    _assert_examples_equal(from_jax, texp.records_to_examples(list(read_records(jpath))))
    _assert_examples_equal(from_jax, jexp.read_game_chunk(jpath))
    from_port = jexp.read_game_chunk(tpath)
    assert len(from_port) == 2 * len(from_jax)
    for f in dataclasses.fields(GameExamples):
        np.testing.assert_array_equal(getattr(from_port, f.name)[:12],
                                      getattr(from_jax, f.name), err_msg=f.name)
    for f in ("stones", "last_moves", "color", "komi", "pi", "pi_aux", "pi_aux_dist",
              "own", "score_margin", "z", "q6", "q16", "q50", "q6_score", "q16_score",
              "q50_score", "mcts_value_dist", "has_pi_aux_dist"):
        np.testing.assert_array_equal(getattr(from_jax, f), game[f], err_msg=f)
    np.testing.assert_array_equal(from_jax.weight, np.ones(12, np.float32))
    name = os.path.basename(tpath)
    assert name.startswith("gen003_b005_g002_n00024_t") and name.endswith("_wA.tfrecord.zz")
    assert os.path.exists(tpath + ".done")


def test_golden_chunk(tmp_path):
    p = texp.write_golden_chunk(str(tmp_path), [b"a", b"bc", b""], gen=3)
    assert os.path.basename(p) == "chunk_0003.tfrecord.zz"
    assert open(p + ".size").read() == "3"
    assert list(read_records(p)) == [b"a", b"bc", b""]
    q = jexp.write_golden_chunk(str(tmp_path / "jax"), [b"a", b"bc", b""], gen=3)
    assert list(read_records(q)) == list(read_records(p))
