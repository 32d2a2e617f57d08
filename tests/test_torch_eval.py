"""The port's gating eval (p3achygo_tpu_torch/eval/) held against the JAX
package: Elo math and player configs equal; six lockstep plies of
`_eval_ply` with the same `tiny` float32 weights, noise_scale 0 and tau 0
give the same moves, resignations, winners, boards and per-player reused
trees (integers exact, floats to 1e-5, the score family to 1e-4: a score
estimate is a sum over 800 bins of values up to +-400 and the trees add
several of them, so float32 summation order moves a game-sized score sum
by ~2e-5); `_half_eval_fn` routes the halves
the same way; `_finish` gives the same result. A board whose two packages'
moves differ is allowed only where the port's improved policy holds the
two moves within 1e-4 (a tie that float rounding may break either way);
such a board is reported and left out from then on, and at most one may
occur."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.eval import elo as jelo
from p3achygo_tpu.eval import harness as jh
from p3achygo_tpu.eval import player_config as jpc
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.mcts import tree as jt
from p3achygo_tpu_torch.constants import BLACK, NUM_MOVES, WHITE
from p3achygo_tpu_torch.eval import elo as telo
from p3achygo_tpu_torch.eval import harness as th
from p3achygo_tpu_torch.eval import player_config as tpc
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.mcts import tree as tt
from torch_parity import random_jax_states, state_to_torch, tiny_pair, to_np, tree_to_torch

torch.set_num_threads(2)

B = 4
PLIES = 6
TOL = 1e-5
SCORE_TOL = 1e-4


def test_elo_matches_jax():
    for w in (0.0, 1e-7, 0.1, 0.5, 0.64, 0.9, 1.0):
        assert telo.relative_elo(w) == jelo.relative_elo(w)
    for wins, n in ((0, 10), (3, 10), (60, 100), (600, 1000), (16, 16), (5, 0)):
        assert telo.elo_with_ci(wins, n) == jelo.elo_with_ci(wins, n)


def test_player_config_matches_jax():
    text = """search_type: puct  # a comment
    n: 64
    k: 4
    tau: 0.5
    use_mcgs: true
    visit_group: 2
    c_puct: 1.5
    root_selection: lcb
    unknown_key: 3"""
    t, j = tpc.parse_player_config(text), jpc.parse_player_config(text)
    assert vars(t) == vars(j)
    assert dataclasses.asdict(t.to_search_params()) == dataclasses.asdict(j.to_search_params())
    assert dataclasses.asdict(t.to_puct_params()) == dataclasses.asdict(j.to_puct_params())
    assert vars(tpc.load_player_config(None)) == vars(jpc.load_player_config(None))


def _cfgs(threshold):
    kw = dict(num_games=B, max_game_len=PLIES, resign_threshold=threshold)
    return (jh.EvalConfig(search=jg.SearchParams(n=4, k=2, noise_scale=0.0, tau=0.0,
                                                 max_depth=4), **kw),
            th.EvalConfig(search=tg.SearchParams(n=4, k=2, noise_scale=0.0, tau=0.0,
                                                 max_depth=4), **kw))


def _start():
    """B boards a few moves into a game, all with black to move."""
    js = random_jax_states(B, 8, seed=21, pass_prob=0.0)
    return js, state_to_torch(js)


def _run_port(tm, threshold, spy=None):
    """The port's six plies from _start(); -> per-ply (states, resigned,
    winner, tree_b, tree_w)."""
    _, cfg = _cfgs(threshold)
    fn = tg.make_eval_fn(tm)
    _, st = _start()
    rcap = th._reuse_capacity(cfg)
    tb, tw = tt.make_tree(B, rcap, "cpu"), tt.make_tree(B, rcap, "cpu")
    res = torch.zeros(B, dtype=torch.bool)
    win = torch.zeros(B, dtype=torch.int8)
    out = []
    for t in range(PLIES):
        even = t % 2 == 0
        tm_, to = (tb, tw) if even else (tw, tb)
        st, res, win, tm_, to = th._eval_ply(None, st, res, win, tm_, to, fn, fn, cfg,
                                             cand_first=even)
        tb, tw = (tm_, to) if even else (to, tm_)
        out.append((st, res, win, tb, tw))
    return out


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=11)


def _threshold(tm):
    """A resign threshold at which some but not all boards resign within
    the six plies. A board resigns at its first ply whose root outcome is
    below the threshold and up to then plays as it would with none, so one
    run without resignation tells: the threshold goes midway between two
    boards' lowest outcomes, at least 1e-6 from every outcome seen (a
    random tiny net values every position near 1/3; float32 rounding moves
    an outcome by ~3e-8)."""
    outcomes = []
    real = th.search_root

    def spy(*a, **kw):
        out = real(*a, **kw)
        outcomes.append(out[0].root_outcome)
        return out
    th.search_root = spy
    try:
        _run_port(tm, -2.0)
    finally:
        th.search_root = real
    vals = torch.stack(outcomes).numpy()  # [ply, board]
    lows = np.sort(vals.min(axis=0))
    for a, b in zip(lows[:-1], lows[1:]):
        thr = float((a + b) / 2)
        if np.abs(vals - thr).min() >= 1e-6:
            return thr
    pytest.fail(f"no usable resign threshold among the root outcomes {vals}")


@pytest.fixture
def jit_jax_scoring(monkeypatch):
    """The JAX harness's _finish scores eagerly (seconds of per-op
    dispatch on the CPU); the same function jitted computes the same."""
    monkeypatch.setattr(jh, "score_board", _JAX_SCORE)


_JAX_SCORE = jax.jit(jh.score_board)


def test_eval_ply_matches_jax(pair, jit_jax_scoring):
    jm, jvars, tm = pair
    thr = _threshold(tm)
    jcfg, tcfg = _cfgs(thr)
    # Both players are the same network here, so the JAX program is built
    # once (cand_first=True) and the port runs the true ply parity;
    # test_half_eval_fn_matches_jax holds the routing of two networks.
    jfn = jg.make_eval_fn(jm, jvars)
    j_ply = jax.jit(functools.partial(jh._eval_ply, fn_cand=jfn, fn_cur=jfn, cfg=jcfg,
                                      cand_first=True))
    rcap = jh._reuse_capacity(jcfg)
    js, _ = _start()
    jb, jw = jt.make_tree(B, rcap), jt.make_tree(B, rcap)
    jres, jwin = jnp.zeros(B, bool), jnp.zeros(B, jnp.int8)
    key = jax.random.PRNGKey(0)

    pis = []
    real = th.search_root

    def spy(*a, **kw):
        out = real(*a, **kw)
        pis.append(out[0].pi_improved)
        return out
    th.search_root = spy
    try:
        port = _run_port(tm, thr)
    finally:
        th.search_root = real

    excused = set()
    for t in range(PLIES):
        even = t % 2 == 0
        tm_, to = (jb, jw) if even else (jw, jb)
        js, key, jres, jwin, tm_, to = j_ply(key, js, jres, jwin, tm_, to)
        jb, jw = (tm_, to) if even else (to, tm_)
        st, res, win, tb, tw = port[t]
        # Moves: the last-move slot of every board that moved this ply.
        jm_, tm_moves = to_np(js.last_moves)[:, -1], st.last_moves[:, -1].numpy()
        for b in np.flatnonzero(jm_ != tm_moves):
            pi = pis[t][b].numpy()
            gap = abs(pi[jm_[b] % NUM_MOVES] - pi[tm_moves[b] % NUM_MOVES])
            assert b in excused or gap < 1e-4, \
                f"ply {t} board {b}: move {tm_moves[b]} != JAX {jm_[b]}, not a tie ({gap})"
            if b not in excused:
                print(f"ply {t} board {b}: improved-policy tie {gap:.2e}, left out")
            excused.add(int(b))
        keep = np.array([b for b in range(B) if b not in excused])
        assert len(keep) >= B - 1, f"{len(excused)} boards tied"
        for name, j, p in (("resigned", jres, res), ("winner", jwin, win)):
            np.testing.assert_array_equal(p.numpy()[keep], to_np(j)[keep], err_msg=name)
        for f in st._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy()[keep],
                                          to_np(getattr(js, f))[keep], err_msg=f"ply {t} {f}")
        for name, jtree, ttree in (("black", jb, tb), ("white", jw, tw)):
            want = tree_to_torch(jtree)
            for f in tt.Tree._fields:
                a = getattr(want, f)[keep]
                b_ = getattr(ttree, f)[keep]
                if a.is_floating_point():
                    atol = SCORE_TOL if "score" in f else TOL
                    np.testing.assert_allclose(b_.float().numpy(), a.float().numpy(), rtol=0,
                                               atol=atol, err_msg=f"ply {t} {name} tree {f}")
                else:
                    np.testing.assert_array_equal(b_.numpy(), a.numpy(),
                                                  err_msg=f"ply {t} {name} tree {f}")
    assert 0 < int(port[-1][1].sum()) < B  # some boards resigned, some played on
    assert (port[-1][3].n[:, 0] > 0).any()  # the trees carried statistics

    # The final result from these boards.
    want = jh._finish(js, jres, jwin, jnp.arange(B) < B // 2, B)
    got = th._finish(port[-1][0], port[-1][1], port[-1][2], torch.arange(B) < B // 2)
    assert vars(got) == vars(want) or excused


def _table_eval(mod, scale, states):
    """A network-free evaluator (its output depends on the stones and on
    `scale`), written once per package."""
    np_ = jnp if mod is jg else torch
    s = states.stones.astype(jnp.float32) if mod is jg else states.stones.float()
    lead = s.sum(axis=1) if mod is jg else s.sum(dim=1)
    logits = scale * s[:, :1] + np_.zeros((s.shape[0], NUM_MOVES))
    return mod.EvalOutput(log_priors=logits, outcome_value=np_.tanh(0.01 * scale * lead),
                          score_est=scale * lead, score_var=np_.ones_like(lead))


def test_half_eval_fn_matches_jax():
    js = random_jax_states(6, 30, seed=3)
    ts = state_to_torch(js)
    for cand_first in (True, False):
        want = jh._half_eval_fn(functools.partial(_table_eval, jg, 1.0),
                                functools.partial(_table_eval, jg, -3.0), cand_first)(js)
        got = th._half_eval_fn(functools.partial(_table_eval, tg, 1.0),
                               functools.partial(_table_eval, tg, -3.0), cand_first)(ts)
        for f in ("log_priors", "outcome_value", "score_est", "score_var"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-6, err_msg=f)


def test_finish_matches_jax(jit_jax_scoring):
    js = random_jax_states(B, 150, seed=9, pass_prob=0.1)
    rng = np.random.default_rng(0)
    for _ in range(3):
        resigned = rng.random(B) < 0.4
        winner = np.where(resigned, rng.choice([BLACK, WHITE], B), 0).astype(np.int8)
        cand_black = rng.random(B) < 0.5
        want = jh._finish(js, jnp.asarray(resigned), jnp.asarray(winner),
                          jnp.asarray(cand_black), B)
        got = th._finish(state_to_torch(js), torch.from_numpy(resigned),
                         torch.from_numpy(winner), torch.from_numpy(cand_black))
        assert vars(got) == vars(want)


def _despair(states):
    """Black is hopeless everywhere in the tree (tests/test_eval.py)."""
    n = states.stones.shape[0]
    v = torch.where(states.to_move == BLACK, -0.99, 0.99)
    return tg.EvalOutput(log_priors=torch.full((n, NUM_MOVES), -float(np.log(NUM_MOVES))),
                         outcome_value=v, score_est=torch.zeros(n), score_var=torch.zeros(n))


def test_resignation_decides_games():
    cfg = th.EvalConfig(num_games=4, max_game_len=12,
                        search=tg.SearchParams(n=4, k=2, noise_scale=0.0, max_depth=6))
    res = th.run_eval(_despair, _despair, cfg, device="cpu")
    assert res.by_resign == 4
    # Black (the first mover) resigns everywhere: cand wins its white games.
    assert res.cand_wins == 2.0


def test_eval_runner_plays_two_models(pair):
    _, _, tm = pair
    _, _, other = tiny_pair(seed=12)
    cfg = th.EvalConfig(num_games=4, max_game_len=8,
                        search=tg.SearchParams(n=4, k=2, noise_scale=1.0, tau=0.0, max_depth=4))
    res = th.EvalRunner(cfg).run(tm, other, torch.Generator().manual_seed(1))
    assert res.num_games == 4 and 0.0 <= res.winrate <= 1.0 and np.isfinite(res.elo)
    assert res.elo_lo <= res.elo <= res.elo_hi


def test_puct_player_raises():
    """A PUCT player no longer raises: its games run to the end (it carries
    no tree while its Gumbel opponent reuses one)."""
    cfg = th.EvalConfig(num_games=2, max_game_len=2,
                        cand=tpc.PlayerSearchConfig(search_type="puct", n=4))
    res = th.run_eval(_despair, _despair, cfg, device="cpu")
    assert res.num_games == 2 and res.by_resign >= 1


MIXED_PLIES = 6


def _mixed_cfgs():
    """PUCT candidate against a Gumbel incumbent with MCGS and the integral
    utility, tree reuse on (no noise, so no draw reaches a search)."""
    kw = dict(num_games=B, max_game_len=MIXED_PLIES)
    puct = dict(search_type="puct", n=8, max_depth=8, root_selection="lcb")
    gumbel = dict(n=8, k=2, max_depth=8, noise_scale=0.0, use_mcgs=True,
                  score_utility_mode="integral")
    return (jh.EvalConfig(cand=jpc.PlayerSearchConfig(**puct),
                          cur=jpc.PlayerSearchConfig(**gumbel), **kw),
            th.EvalConfig(cand=tpc.PlayerSearchConfig(**puct),
                          cur=tpc.PlayerSearchConfig(**gumbel), **kw))


def test_puct_against_mcgs_integral_matches_jax(jit_jax_scoring):
    """Whole lockstep games: every ply's boards, resignations, winners and
    both colors' reused trees (MCGS under tree reuse: the compaction keeps
    what the JAX one keeps), then the same wins and Elo."""
    from test_torch_mcgs import _peaked_tables
    from test_torch_search_extras import _jax_eval, _torch_eval

    tab = _peaked_tables(2)
    jfn, tfn = functools.partial(_jax_eval, tab), functools.partial(_torch_eval, tab)
    jcfg, tcfg = _mixed_cfgs()
    assert th._reuse_capacity(tcfg) == jh._reuse_capacity(jcfg) == 10
    j_ply = {even: jax.jit(functools.partial(jh._eval_ply, fn_cand=jfn, fn_cur=jfn, cfg=jcfg,
                                             cand_first=even)) for even in (True, False)}
    rcap = th._reuse_capacity(tcfg)
    js, ts = _start()
    jb, jw = jt.make_tree(B, rcap), jt.make_tree(B, rcap)
    tb, tw = tt.make_tree(B, rcap, "cpu"), tt.make_tree(B, rcap, "cpu")
    jres, jwin = jnp.zeros(B, bool), jnp.zeros(B, jnp.int8)
    tres, twin = torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int8)
    key = jax.random.PRNGKey(0)
    tg.COUNTERS.reset()
    for t in range(MIXED_PLIES):
        even = t % 2 == 0
        jm_, jo = (jb, jw) if even else (jw, jb)
        js, key, jres, jwin, jm_, jo = j_ply[even](key, js, jres, jwin, jm_, jo)
        jb, jw = (jm_, jo) if even else (jo, jm_)
        tm_, to = (tb, tw) if even else (tw, tb)
        ts, tres, twin, tm_, to = th._eval_ply(None, ts, tres, twin, tm_, to, tfn, tfn,
                                               tcfg, cand_first=even)
        tb, tw = (tm_, to) if even else (to, tm_)
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(ts, f).numpy(), to_np(getattr(js, f)),
                                          err_msg=f"ply {t} {f}")
        np.testing.assert_array_equal(tres.numpy(), to_np(jres))
        np.testing.assert_array_equal(twin.numpy(), to_np(jwin))
        for name, jtree, ttree in (("black", jb, tb), ("white", jw, tw)):
            want = tree_to_torch(jtree)
            for f in tt.Tree._fields:
                a, b_ = getattr(want, f), getattr(ttree, f)
                if a.is_floating_point():
                    np.testing.assert_allclose(b_.float().numpy(), a.float().numpy(), rtol=0,
                                               atol=TOL, err_msg=f"ply {t} {name} tree {f}")
                else:
                    np.testing.assert_array_equal(b_.numpy(), a.numpy(),
                                                  err_msg=f"ply {t} {name} tree {f}")
    assert tg.COUNTERS.searches == 2 * MIXED_PLIES  # a PUCT and a Gumbel half per ply
    assert (tw.n[:, 0] > 0).any()  # the Gumbel player's reused trees carry statistics
    want = jh._finish(js, jres, jwin, jnp.arange(B) < B // 2, B)
    got = th._finish(ts, tres, twin, torch.arange(B) < B // 2)
    assert vars(got) == vars(want)
    # run_eval plays the same games from fresh boards.
    res = th.run_eval(tfn, tfn, tcfg, device="cpu")
    assert res.num_games == B and 0.0 <= res.winrate <= 1.0


def test_player_config_passes_search_options():
    text = "search_type: gumbel\nuse_mcgs: true\nscore_utility_mode: integral\nn: 16\n"
    t, j = tpc.parse_player_config(text), jpc.parse_player_config(text)
    assert dataclasses.asdict(t.to_search_params()) == dataclasses.asdict(j.to_search_params())
    sp = t.to_search_params()
    assert sp.use_mcgs and sp.score_utility_mode == "integral"
    assert dataclasses.asdict(t.to_puct_params()) == dataclasses.asdict(j.to_puct_params())
