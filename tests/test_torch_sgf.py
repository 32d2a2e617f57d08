"""The port's SGF module (p3achygo_tpu_torch/sgf/sgf.py) and
`selfplay/records.py game_to_sgf` held against the JAX package: the same
text byte for byte from the same games and trees, the same parse of it,
and tests/test_sgf.py's round trips. (The JAX package's SGF code is numpy
and Python, so the tree test hands it the port tree's arrays.)"""
import types

import numpy as np
import pytest
import torch

from p3achygo_tpu import sgf as jsgf
from p3achygo_tpu.selfplay.records import game_to_sgf as jax_game_to_sgf
from p3achygo_tpu_torch import sgf as tsgf
from p3achygo_tpu_torch.constants import BLACK, PASS_MOVE, WHITE
from p3achygo_tpu_torch.game.board import new_state
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, search_root, uniform_eval_fn
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.selfplay.records import game_to_sgf

torch.set_num_threads(2)


def _random_game(seed: int, L: int):
    rng = np.random.default_rng(seed)
    to_move = np.where(np.arange(L) % 2 == 0, BLACK, WHITE).astype(np.int8)
    move = rng.integers(0, 362, L).astype(np.int16)
    move[rng.random(L) < 0.1] = PASS_MOVE
    return to_move, move


def test_coords_match_jax():
    for a in list(range(0, 362, 7)) + [360, PASS_MOVE, -1]:
        assert tsgf.loc_to_sgf(a) == jsgf.loc_to_sgf(a)
    for s in ("", "tt", "aa", "dc", "sa", "ss"):
        assert tsgf.sgf_to_loc(s) == jsgf.sgf_to_loc(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serialize_game_byte_equal_and_round_trips(seed):
    to_move, move = _random_game(seed, 40 + 7 * seed)
    moves = [(int(c), int(m)) for c, m in zip(to_move, move)]
    for kw in ({}, {"komi": 6.5, "result": "W+2.5"}, {"komi": 20.5, "result": "B+R",
                                                      "pb": "a]b", "pw": "c\\d"}):
        text = tsgf.serialize_game(moves, **kw)
        assert text == jsgf.serialize_game(moves, **kw)
        root = tsgf.parse_sgf(text)
        assert tsgf.extract_moves(root) == moves
        assert tsgf.game_info(root) == jsgf.game_info(jsgf.parse_sgf(text))


@pytest.mark.parametrize("scores", [(180.0, 172.5), (170.0, 180.5), (0.0, 7.5)])
def test_game_to_sgf_byte_equal(scores):
    to_move, move = _random_game(7, 30)
    for L in (0, 1, 30):
        for by_resign in (False, True):
            args = (to_move, move, L, scores[0], scores[1], 7.5, by_resign)
            text = game_to_sgf(*args)
            assert text == jax_game_to_sgf(*args)
            assert tsgf.extract_moves(tsgf.parse_sgf(text)) == \
                [(int(c), int(m)) for c, m in zip(to_move[:L], move[:L])]


def test_parse_matches_jax_on_variations_and_escapes():
    for text in ("(;GM[1]SZ[19];B[dd](;W[qq];B[dc])(;W[pp]))",
                 "(;GM[1]C[a \\] bracket];B[dd])",
                 "( ;GM[1] KM[0.5]\n;B[aa] ;W[] ;B[tt] )"):
        t, j = tsgf.parse_sgf(text), jsgf.parse_sgf(text)
        assert tsgf.extract_moves(t) == jsgf.extract_moves(j)
        assert [n.props for n in tsgf.main_line(t)] == [n.props for n in jsgf.main_line(j)]
    for bad in ("", "(;B[dd]", "(x)"):
        with pytest.raises(ValueError):
            tsgf.parse_sgf(bad)


def test_result_string_matches_jax():
    for args in ((180.0, 172.5), (170.0, 180.5), (0, 0, True, BLACK), (0, 0, True, WHITE)):
        assert tsgf.result_string(*args) == jsgf.result_string(*args)


def test_serialize_game_with_tree_byte_equal():
    """The full-tree SGF of a port search tree is the JAX function's text
    on the same tree's arrays, byte for byte."""
    states = new_state(1, 7.5, device="cpu")
    p = SearchParams(n=16, k=4, noise_scale=0.0, max_depth=8)
    _, work = search_root(states, uniform_eval_fn, p, generator=torch.Generator().manual_seed(5),
                          init_tree=make_tree(1, 18, "cpu"), reuse_capacity=18)
    arrays = types.SimpleNamespace(**{f: getattr(work, f).float().numpy()
                                      if getattr(work, f).dtype == torch.bfloat16
                                      else getattr(work, f).numpy() for f in work._fields})
    moves = [(BLACK, 60), (WHITE, 72)]
    text = tsgf.serialize_game_with_tree(moves, work, komi=7.5)
    assert text == jsgf.serialize_game_with_tree(moves, arrays, komi=7.5)
    assert tsgf.extract_moves(tsgf.parse_sgf(text))[:2] == moves
    assert text.count("(") >= 3 and "nn_score_est" in text
