"""The benchmark's plain references on the CPU: the rules engine on hand
positions and against the batched random-game maker, the float32
network against a forward written out with torch's own BatchNorm, and
against the program's float32 forward on the same weights, and the search's
schedule and improved policy by hand and against the program's search."""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench.harness.weights import make_weights
from portbench.reference import rules
from portbench.reference import search as ref_search
from portbench.reference.network import (
    SYM_GATHER,
    SYM_SCATTER,
    Network,
    features,
    is_broadcast,
    mish,
    parameter_shapes,
    symmetry_index,
)

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference")
TINY = dict(blocks=6, conv_size=3, broadcast_interval=4, inner_bottleneck_layers=1,
            channels=16, bottleneck_channels=8, head_channels=8, c_val=16)
SMALL = dict(blocks=5, conv_size=3, broadcast_interval=3, inner_bottleneck_layers=3,
             channels=32, bottleneck_channels=16, head_channels=8, c_val=24)


def pt(row, col):
    return row * rules.BOARD + col


def board(black=(), white=()):
    s = np.zeros(rules.POINTS, np.int8)
    for r, c in black:
        s[pt(r, c)] = rules.BLACK
    for r, c in white:
        s[pt(r, c)] = rules.WHITE
    return s


def test_capture_in_the_corner_and_on_the_edge():
    g = rules.Game(board(black=[(0, 1)], white=[(0, 0)]), rules.BLACK, 600)
    assert g.why_illegal(pt(1, 0)) == ""
    g.play(pt(1, 0))
    assert g.stones[pt(0, 0)] == rules.EMPTY
    assert g.ko == -1  # the capturing stone joins no chain but has two liberties
    # A two-stone chain on the edge.
    g = rules.Game(board(black=[(0, 2), (0, 3), (1, 1)], white=[(0, 1)]), rules.BLACK, 600)
    g.play(pt(5, 5))  # black tenuki
    g.play(pt(9, 9))  # white tenuki
    assert g.why_illegal(pt(0, 0)) == ""
    g.play(pt(0, 0))
    assert g.stones[pt(0, 1)] == rules.EMPTY


def test_self_capture_is_illegal_and_capture_first():
    g = rules.Game(board(black=[(0, 1), (1, 0)]), rules.WHITE, 600)
    assert g.why_illegal(pt(0, 0)) == "self-capture"
    assert g.cheap_illegal()[pt(0, 0)]
    # Filling its own last liberty is legal when it captures first.
    g = rules.Game(board(black=[(0, 1), (1, 0), (2, 1)], white=[(1, 1), (0, 2), (1, 2)]),
                   rules.WHITE, 600)
    assert g.why_illegal(pt(0, 0)) == ""
    g.play(pt(0, 0))
    assert g.stones[pt(0, 1)] == rules.EMPTY


def test_simple_ko_and_positional_superko():
    # Black captures at (1, 2); white may not retake at once.
    g = rules.Game(board(black=[(0, 1), (1, 0), (2, 1)],
                         white=[(0, 2), (1, 3), (2, 2), (1, 1)]), rules.BLACK, 600)
    g.play(pt(1, 2))
    assert g.stones[pt(1, 1)] == rules.EMPTY
    assert g.ko == pt(1, 1)
    assert g.cheap_illegal()[pt(1, 1)]
    assert g.why_illegal(pt(1, 1)) == "positional superko"
    # After an exchange elsewhere the ko may be taken back.
    g.play(pt(10, 10))
    g.play(pt(15, 15))
    assert g.ko == -1 and g.why_illegal(pt(1, 1)) == ""


def test_superko_beyond_simple_ko():
    """A move that recreates any earlier position of the game is illegal
    though no simple-ko point forbids it; the search's cheap legality does
    not see it. The earlier position is put into the game's history by
    hand here: the stones after black's next move at (6, 6)."""
    g = rules.Game(board(black=[(0, 1)], white=[(1, 1)]), rules.WHITE, 600)
    start = g.stones.copy()
    g.play(pt(5, 5))
    earlier = g.stones.copy()
    earlier[pt(6, 6)] = rules.BLACK
    g.seen.add(earlier.tobytes())
    assert g.ko == -1
    assert g.why_illegal(pt(6, 6)) == "positional superko"
    assert not g.cheap_illegal()[pt(6, 6)]
    assert start.tobytes() in g.seen


def test_two_passes_end_the_game_and_max_len():
    g = rules.Game(np.zeros(rules.POINTS, np.int8), rules.BLACK, 3)
    g.play(rules.PASS)
    assert not g.over()
    g.play(pt(3, 3))
    g.play(rules.PASS)
    assert g.over()  # move_count reached 3
    assert g.last_moves == [rules.NOOP, rules.NOOP, rules.PASS, pt(3, 3), rules.PASS]


def test_random_games_replay_in_the_one_board_engine():
    rng = np.random.default_rng(11)
    lengths = np.arange(48) * 3
    stones, to_move, moves = rules.random_games(lengths, rng)
    for b in range(48):
        g = rules.Game(np.zeros(rules.POINTS, np.int8), rules.BLACK, 600)
        for t in range(lengths[b]):
            m = int(moves[b, t])
            assert m >= 0
            why = g.why_illegal(m)
            if why == "positional superko":  # not checked by the maker
                pytest.skip("a random game repeated a position")
            assert why == "", (b, t, why)
            g.play(m)
        np.testing.assert_array_equal(g.stones, stones[b])
        assert g.to_move == to_move[b]
    libs = rules.batch_point_liberties(stones)
    for b in range(0, 48, 5):
        np.testing.assert_array_equal(libs[b], rules.point_liberties(stones[b]))


def test_reference_imports_nothing_of_the_program_or_jax():
    for name in os.listdir(REF_DIR):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "p3achygo_tpu", "p3achygo_tpu_torch"), \
                    (name, m)


def layer_by_layer(cfg, p, planes, scalars):
    """The forward with torch's eval-mode BatchNorm and F.mish, unfolded."""
    F = torch.nn.functional

    def bn(name, x):
        return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                            p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, 1e-3)

    def cb(name, x):
        w = p[f"{name}.Conv_0.weight"]
        return F.conv2d(F.mish(bn(f"{name}.BatchNorm_0", x)), w, padding=w.shape[-1] // 2)

    x = F.conv2d(planes, p["init_board_conv.weight"], padding=2)
    x = x + F.linear(scalars, p["init_game_layer.weight"], p["init_game_layer.bias"])[:, :, None, None]
    for i in range(cfg["blocks"]):
        if is_broadcast(cfg, i):
            n = f"broadcast_res_{i}"
            y = cb(f"{n}.conv_first", x)
            y = F.linear(F.mish(y).flatten(2), p[f"{n}.mix.Dense_0.weight"],
                         p[f"{n}.mix.Dense_0.bias"]).reshape(y.shape)
            x = x + cb(f"{n}.conv_last", y)
        else:
            n = f"bottleneck_res_{i}"
            y = cb(f"{n}.reduce", x)
            for j in range(cfg["inner_bottleneck_layers"]):
                y = cb(f"{n}.inner_{j}", y)
            x = x + cb(f"{n}.expand", y)
    pool = lambda t: torch.cat([t.mean(dim=(2, 3)), t.amax(dim=(2, 3))], dim=1)
    g = F.conv2d(x, p["policy_head.conv_g.weight"])
    gp = pool(F.mish(bn("policy_head.gpool.batch_norm_gpool", g)))
    pp = F.conv2d(x, p["policy_head.conv_p.weight"]) + F.linear(
        gp, p["policy_head.gpool.Dense_0.weight"], p["policy_head.gpool.Dense_0.bias"])[:, :, None, None]
    moves = F.conv2d(F.mish(pp), p["policy_head.output_moves.weight"]).flatten(2)[:, 0]
    pas = F.linear(gp, p["policy_head.output_pass.weight"], p["policy_head.output_pass.bias"])[:, :1] - 3
    return torch.cat([moves, pas], dim=1)


@pytest.mark.parametrize("cfg", [TINY, SMALL], ids=["tiny", "small"])
def test_network_against_an_unfolded_forward(cfg):
    torch.manual_seed(0)
    params = make_weights(cfg, 2 ** 31 + 5, torch.device("cpu"))
    assert set(params) == set(parameter_shapes(cfg))
    net = Network(cfg, params, torch.device("cpu"))
    planes = (torch.rand(6, 15, 19, 19) < 0.3).float()
    scalars = torch.rand(6, 8)
    got = net.forward(planes, scalars)["pi_logits"]
    want = layer_by_layer(cfg, params, planes, scalars)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert float(mish(torch.tensor(1.0))) == pytest.approx(0.8650984, rel=1e-6)


def test_evaluation_against_the_programs_float32_forward():
    """The same weights in the program's float32 model and eval function:
    the reference's search view agrees to float32 rounding (a second
    witness that both implement p3achygo's network, symmetry and
    features)."""
    from p3achygo_tpu_torch.game.board import from_stones
    from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
    from p3achygo_tpu_torch.models.config import ModelConfig
    from p3achygo_tpu_torch.models.model import build_model

    cfg = TINY
    params = make_weights(cfg, 77, torch.device("cpu"))
    model = build_model(ModelConfig(trunk_block_type="btl", **cfg), torch.float32, "cpu")
    model.load_state_dict(params)
    rng = np.random.default_rng(3)
    stones, to_move, moves = rules.random_games(rng.integers(0, 120, 16), rng)
    states = from_stones(torch.from_numpy(stones), 7.5, torch.from_numpy(to_move), device="cpu")
    last = np.full((16, 5), -1, np.int64)
    for b in range(16):
        played = [int(m) for m in moves[b] if m >= 0][-5:]
        if played:
            last[b, -len(played):] = played
    states = states._replace(last_moves=torch.from_numpy(last).to(torch.int32))
    out = make_eval_fn(model, symmetrize=True)(states)
    ref = Network(cfg, params, torch.device("cpu")).evaluate(
        stones, to_move, last, np.full(16, 7.5, np.float32))
    torch.testing.assert_close(out.log_priors, ref.log_priors, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.outcome_value, ref.value, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.score_est, ref.score_est, rtol=1e-4, atol=2e-3)
    torch.testing.assert_close(out.err_est, ref.err_est, rtol=1e-4, atol=1e-4)


def test_symmetry_tables_are_inverse_and_the_hash_matches_the_program():
    from p3achygo_tpu_torch.game.board import compute_hash

    for s in range(8):
        np.testing.assert_array_equal(SYM_GATHER[s][SYM_SCATTER[s]], np.arange(rules.POINTS))
    rng = np.random.default_rng(1)
    stones = rng.integers(-1, 2, (20, rules.POINTS)).astype(np.int8)
    want = compute_hash(torch.from_numpy(stones))[:, 0].numpy() % 8
    np.testing.assert_array_equal(symmetry_index(stones), want)


def test_features_of_a_hand_position():
    s = board(black=[(0, 0)], white=[(0, 1)])
    last = np.array([[-1, -1, -1, pt(0, 1), rules.PASS]])
    planes, scalars = features(s[None], np.array([rules.WHITE], np.int8), last,
                               np.array([7.5], np.float32))
    flat = planes.reshape(15, rules.POINTS)
    assert flat[0, pt(0, 1)] == 1 and flat[1, pt(0, 0)] == 1  # own white, opp black
    assert flat[5, pt(0, 1)] == 1 and flat[6].sum() == 0  # the pass marks no point
    assert flat[8, pt(0, 0)] == 1  # the black stone is in atari
    np.testing.assert_allclose(scalars[0], [0, 1, 0, 0, 0, 0, 1, 0.5])


@pytest.mark.parametrize("n,k,schedule,added", [
    (128, 8, [(8, 5), (4, 11), (2, 21)], 8 * 5 + 4 * 11 + 2 * 21),
    (32, 5, [(5, 3), (2, 8)], 5 * 3 + 2 * 8),
    (8, 4, [(4, 1), (2, 2)], 4 * 1 + 2 * 2),
])
def test_the_search_schedule_by_hand(n, k, schedule, added):
    assert ref_search.schedule(n, k) == schedule
    assert ref_search.visits_added(n, k, 362) == added
    # Two legal moves: every round keeps both, each with its v_r.
    assert ref_search.visits_added(n, k, 2) == 2 * sum(v for _, v in schedule)
    assert ref_search.tier_sizes(1024, 0.25) == (256, 768)
    assert ref_search.tier_sizes(256, 0.25) == (64, 192)


def test_the_improved_policy_is_the_programs_target():
    """From the program's own stored priors, legal moves, child visits, Q and
    root utility, the reference's target is the one the program's search
    returned, and the visits it added are the schedule's."""
    from p3achygo_tpu_torch.game.board import from_stones
    from p3achygo_tpu_torch.mcts.gumbel import EvalOutput, SearchParams, search_root
    from p3achygo_tpu_torch.mcts.tree import make_tree

    stones, to_move, _ = rules.random_games(np.array([0, 12, 40, 90]), np.random.default_rng(5))
    states = from_stones(torch.from_numpy(stones), 7.5, torch.from_numpy(to_move), device="cpu")
    proj = torch.randn(361, 365, generator=torch.Generator().manual_seed(3)) / 8

    def eval_fn(st):
        x = st.stones.float() @ proj
        return EvalOutput(torch.log_softmax(x[:, :362], dim=-1), torch.tanh(x[:, 362]),
                          x[:, 363], x[:, 364].abs() + 1.0, None)

    params = SearchParams(n=24, k=4, visit_group=2)
    res, tree = search_root(states, eval_fn, params, generator=torch.Generator().manual_seed(7),
                            init_tree=make_tree(4, 8, "cpu"), reuse_capacity=8)
    legal = tree.s_legal[:, 0].numpy()
    visits = res.root_child_visits.numpy()
    got = ref_search.improved_policy(tree.log_priors[:, 0].float().numpy(), legal, visits,
                                     res.root_child_q.numpy(), tree.init_util[:, 0].numpy(),
                                     np.full(4, 24), np.full(4, 4), params.c_visit, params.c_scale)
    # float64 here against the program's float32: a few parts in a million.
    np.testing.assert_allclose(got, res.pi_improved.numpy(), rtol=2e-5, atol=1e-8)
    assert visits.sum(axis=1).tolist() == [ref_search.visits_added(24, 4, int(c))
                                           for c in legal.sum(axis=1)]
