"""The port's generation loop (p3achygo_tpu_torch/rl/loop.py, rl/__main__.py,
selfplay/loop.py reset_finished, train/render.py) held against the JAX
package, and run whole on the CPU.

Parity: `reset_finished` with restart states, per-board komi, no_raw and
force_sel, given the same uniforms, is equal field by field; `_harvest`
of finished JAX games (the JAX method run on a namespace holding only the
attributes it reads, as tests/test_torch_slice.py does) gives the same
replay and val-replay rows, move stats, reuse buffer, fork bookkeeping,
SGF files and restart positions; `_build_restart_batch` draws the same
restarts from the same numpy seed; `render_sample` writes the same text.
No sel_mult is compared here, so the pre-search KLD rounding of jitted
JAX (ROADMAP Queue 3) needs no masking.

Whole loop (tests/test_resume.py's tiny configuration, float32): resume
round trip, fresh-directory resume, replay persistence, the golden's
independence from training, momentum and the per-generation LR across
train_and_gate, the search options of config/ci-tiny.json and of exact
terminal scoring with the value-bias cache (a generation each), the bias
table under resume and harvest, and the command line."""
import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.data.replay import ReplayBuffer as JaxReplay
from p3achygo_tpu.game.board import from_stones as jax_from_stones
from p3achygo_tpu.mcts.tree import make_tree as jax_make_tree
from p3achygo_tpu.rl import config as jconfig
from p3achygo_tpu.rl.loop import GenerationLoop as JaxLoop
from p3achygo_tpu.selfplay import fork as jfork
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu.selfplay import reuse as jreuse
from p3achygo_tpu.selfplay.stats import MoveStatsBatch as JaxMoveStats
from p3achygo_tpu.train.render import render_sample as jax_render_sample
from p3achygo_tpu_torch.data.replay import ReplayBuffer
from p3achygo_tpu_torch.game.board import GoState, from_stones
from p3achygo_tpu_torch.rl import config as tconfig
from p3achygo_tpu_torch.rl.__main__ import main
from p3achygo_tpu_torch.rl.loop import GenerationLoop
from p3achygo_tpu_torch.selfplay import fork as tfork
from p3achygo_tpu_torch.selfplay import loop as tl
from p3achygo_tpu_torch.selfplay import reuse as treuse
from p3achygo_tpu_torch.selfplay.records import GameExamples
from p3achygo_tpu_torch.selfplay.stats import MoveStatsBatch
from p3achygo_tpu_torch.train.lr_schedule import lr_for_gen
from p3achygo_tpu_torch.train.render import render_sample
from test_resume import tiny_run_cfg as jax_tiny_run_cfg
from torch_parity import jax_selfplay_games, state_to_torch, tiny_pair, to_np, tree_to_torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_run_cfg(**kw) -> tconfig.RunConfig:
    """tests/test_resume.py's tiny configuration as the port's RunConfig."""
    return tconfig.RunConfig(**{**dataclasses.asdict(jax_tiny_run_cfg()), **kw})


def _loop(tmp_path, name="run", seed=5, **kw) -> GenerationLoop:
    return GenerationLoop(tiny_run_cfg(**kw), root_dir=str(tmp_path / name), seed=seed,
                          dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------- parity

def _restart_inputs(B: int, seed: int):
    """Numpy restart positions: stones, last moves, colors, move numbers,
    komi, and the done / use_init / no_raw / force_sel masks."""
    rng = np.random.default_rng(seed)
    stones = np.where(rng.random((B, 361)) < 0.3, rng.choice([1, -1], (B, 361)), 0)
    return dict(stones=stones.astype(np.int8),
                last_moves=rng.integers(-1, 362, (B, 5)).astype(np.int32),
                to_move=rng.choice([1, -1], B).astype(np.int8),
                move_num=rng.integers(0, 200, B).astype(np.int32),
                komi=rng.choice([-0.5, 6.5, 7.5, 20.5], B).astype(np.float32),
                done=rng.random(B) < 0.7, use=rng.random(B) < 0.6,
                no_raw=rng.random(B) < 0.4, force=rng.random(B) < 0.4)


@pytest.fixture(scope="module")
def finished_games():
    B, T = 8, 12
    states, buf = jax_selfplay_games(B, T, T + 1, seed=1)
    return B, T, states, buf


def test_reset_finished_with_restarts_matches_jax(finished_games):
    B, T, js, jbuf = finished_games
    r = _restart_inputs(B, seed=2)
    j_init = jax.vmap(lambda s, lm, c, k, m: jax_from_stones(s, k, 1)._replace(
        last_moves=lm, to_move=c, move_count=m))(
        *(jnp.asarray(r[k]) for k in ("stones", "last_moves", "to_move", "komi", "move_num")))
    t_init = from_stones(r["stones"], torch.from_numpy(r["komi"]), 1, device="cpu")._replace(
        last_moves=torch.from_numpy(r["last_moves"]), to_move=torch.from_numpy(r["to_move"]),
        move_count=torch.from_numpy(r["move_num"]))
    jaux = jl.make_aux(jax.random.PRNGKey(3), B)._replace(force_sel=jnp.asarray(r["force"][::-1]))
    key = jax.random.PRNGKey(7)
    uniform = torch.tensor(np.array(jax.random.uniform(key, (B,))))
    jtree = jax_make_tree(B, 6)
    want = jl.reset_finished(js, jbuf, jaux, jnp.asarray(r["done"]), jnp.asarray(r["komi"]), key,
                             j_init, jnp.asarray(r["use"]), max_raw_policy_moves=30,
                             reuse_tree=jtree, no_raw=jnp.asarray(r["no_raw"]),
                             force_sel=jnp.asarray(r["force"]))
    tbuf = tl.GameBuffer(**{f: torch.tensor(np.asarray(getattr(jbuf, f)))
                            for f in tl.GameBuffer._fields})
    taux = tl.SelfplayAux(*(torch.tensor(np.asarray(a)) for a in jaux))
    got = tl.reset_finished(state_to_torch(js), tbuf, taux, torch.from_numpy(r["done"]),
                            torch.from_numpy(r["komi"]), max_raw_policy_moves=30,
                            reuse_tree=tree_to_torch(jtree), uniform=uniform,
                            init_states=t_init, use_init=torch.from_numpy(r["use"]),
                            no_raw=torch.from_numpy(r["no_raw"]),
                            force_sel=torch.from_numpy(r["force"]))
    for part, j, t in zip(("state", "buf", "aux", "tree"), want, got):
        for f in type(t)._fields:
            a, b = to_np(getattr(j, f)), getattr(t, f)
            b = (b.float() if b.dtype == torch.bfloat16 else b).numpy()
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f"{part}.{f}")
    done = r["done"]
    assert (got[0].move_count.numpy()[done & r["use"]] > 0).any()
    assert (got[2].raw_until.numpy() == got[0].move_count.numpy())[done & r["no_raw"]].all()


def _jax_namespace(jm, jvars, cfg, states, buf, B, T, seed, sgf_dir):
    """The attributes JAX GenerationLoop._harvest and _build_restart_batch
    read, without building (and compiling) a JAX loop."""
    ns = types.SimpleNamespace(
        cfg=cfg, sp_cfg=jl.SelfplayConfig(batch_size=B, max_game_len=T),
        states=states, buf=buf, aux=jl.make_aux(jax.random.PRNGKey(1), B),
        tree=jax_make_tree(B, 6), bias=None, key=jax.random.PRNGKey(0),
        replay=JaxReplay(capacity=cfg.replay_capacity, seed=seed),
        val_replay=JaxReplay(capacity=1 << 16, seed=seed + 3),
        _score_fn=jax.jit(jl.final_scores), _np_rng=np.random.default_rng(seed + 2),
        _move_stats=[], reuse=jreuse.make_reuse_buffer(cfg.reuse_buffer_type, seed=seed),
        golden=jvars, game_sink=None, sgf_dir=sgf_dir,
        _init_mv=np.zeros(B, np.int32), _is_fresh=np.ones(B, bool),
        _HANDICAP_STONES=JaxLoop._HANDICAP_STONES)
    fp = (jfork.ForkParams.for_reuse(cfg.use_seen_state_prob)
          if cfg.use_seen_state_prob > 0 else jfork.ForkParams())  # as JAX __init__
    ns.fork = jfork.ForkManager(fp, ns.reuse, jfork.ForkEvaluator(model=jm), seed=seed)
    ns._fork_plans = [ns.fork.new_plan(True) for _ in range(B)]
    for name in ("_harvest", "_build_restart_batch", "_note_new_game"):
        setattr(ns, name, functools.partial(getattr(JaxLoop, name), ns))
    return ns


def _seed_reuse(buf, mod, n):
    """n restart states with every first-move behavior, the same in both
    packages."""
    rng = np.random.default_rng(5)
    for i in range(n):
        buf.add(mod.InitState(stones=np.where(rng.random(361) < 0.2, 1, 0).astype(np.int8),
                              last_moves=rng.integers(0, 361, 5).astype(np.int16),
                              to_move=int(rng.choice([1, -1])), move_num=3 + i,
                              komi=None if i % 3 == 0 else 5.5,
                              first_move_behavior=i % 3))


def _same_init_states(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v, err_msg=f.name)
            else:
                assert u == v, f.name


def test_harvest_matches_jax(finished_games, tmp_path):
    B, T, states, buf = finished_games
    jm, jvars, tm = tiny_pair(seed=3)
    kw = dict(selfplay_batch_size=B, selfplay_max_game_len=T, val_game_frac=0.3,
              handicap_game_prob=0.2, play_from_book_prob=0.2, use_seen_state_prob=0.3,
              replay_capacity=1 << 12)
    seed = 9
    ns = _jax_namespace(jm, jvars, jconfig.RunConfig(**{**dataclasses.asdict(jax_tiny_run_cfg()),
                                                        **kw}),
                        states, buf, B, T, seed, str(tmp_path / "jsgf"))
    loop = _loop(tmp_path, seed=seed, **kw)
    loop.golden.load_state_dict(tm.state_dict())
    loop.sgf_dir = str(tmp_path / "tsgf")
    loop.states = state_to_torch(states)
    loop.buf = tl.GameBuffer(**{f: torch.tensor(np.asarray(getattr(buf, f)))
                                for f in tl.GameBuffer._fields})
    loop.tree = tree_to_torch(ns.tree)
    # Plans: fork jobs for the flush on four boards, host forks on two;
    # restarts draw from a seeded reuse buffer.
    plans = [("late", 3), ("sample_t1", 5), ("uniform", 4), ("regret", -1),
             ("sample_uniform", 2), ("early", 6), ("uniform", 7), ("late", 9)]
    ns._fork_plans = [jfork.ForkPlan(*p) for p in plans]
    loop._fork_plans = [tfork.ForkPlan(*p) for p in plans]
    _seed_reuse(ns.reuse, jreuse, 6)
    _seed_reuse(loop.reuse, treuse, 6)
    done = np.array(jl.finished_mask(states, ns.sp_cfg))
    done[5] = False  # one board stays in play
    assert done.sum() >= 6

    ns._harvest(done)
    loop._harvest(done)

    for name in ("replay", "val_replay"):
        jr, tr = getattr(ns, name), getattr(loop, name)
        assert (len(tr), tr.games_added) == (len(jr), jr.games_added)
        for f, arr in jr._data.items():
            np.testing.assert_array_equal(tr._data[f][:len(jr)], arr[:len(jr)], err_msg=f)
    assert len(loop.val_replay) > 0 and len(loop.replay) > 0
    want, got = JaxMoveStats.concatenate(ns._move_stats), MoveStatsBatch.concatenate(loop._move_stats)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)
    assert loop.fork.counts == ns.fork.counts and sum(loop.fork.counts.values()) >= 4
    _same_init_states(loop.reuse._buf, ns.reuse._buf)
    np.testing.assert_array_equal(loop._init_mv, ns._init_mv)
    np.testing.assert_array_equal(loop._is_fresh, ns._is_fresh)
    assert [p and dataclasses.asdict(p) for p in loop._fork_plans] == \
        [p and dataclasses.asdict(p) for p in ns._fork_plans]
    assert sorted(os.listdir(loop.sgf_dir)) == sorted(os.listdir(ns.sgf_dir))
    for name in os.listdir(ns.sgf_dir):
        with open(os.path.join(ns.sgf_dir, name)) as a, open(os.path.join(loop.sgf_dir, name)) as b:
            assert a.read() == b.read(), name
    # The restarted boards: the same positions and options (raw-policy
    # lengths come from each package's own generator).
    for f in GoState._fields:
        np.testing.assert_array_equal(getattr(loop.states, f).numpy(),
                                      to_np(getattr(ns.states, f)), err_msg=f)
    np.testing.assert_array_equal(loop.aux.force_sel.numpy(), np.asarray(ns.aux.force_sel))
    assert (~loop._is_fresh).any() and (loop.states.move_count.numpy() > 0).any()


@pytest.mark.parametrize("probs", [(0.3, 0.3, 0.3), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)])
def test_build_restart_batch_matches_jax(tmp_path, probs):
    """(book, handicap, seen-state) probabilities; 24 boards restart."""
    B = 24
    book, handicap, seen = probs
    kw = dict(selfplay_batch_size=B, play_from_book_prob=book, handicap_game_prob=handicap,
              use_seen_state_prob=seen)
    ns = _jax_namespace(None, None, jconfig.RunConfig(**{**dataclasses.asdict(jax_tiny_run_cfg()),
                                                         **kw}),
                        None, None, B, 12, 4, None)
    loop = _loop(tmp_path, seed=4, **kw)
    _seed_reuse(ns.reuse, jreuse, 10)
    _seed_reuse(loop.reuse, treuse, 10)
    idx = np.arange(0, B, 1 if seen < 1 else 2)
    want = ns._build_restart_batch(idx)
    got = loop._build_restart_batch(idx)
    for f in GoState._fields:
        np.testing.assert_array_equal(getattr(got[0], f).numpy(), to_np(getattr(want[0], f)),
                                      err_msg=f)
    for name, a, b in zip(("use", "komi", "no_raw", "force"), want[1:], got[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_array_equal(loop._init_mv, ns._init_mv)
    assert [p and dataclasses.asdict(p) for p in loop._fork_plans] == \
        [p and dataclasses.asdict(p) for p in ns._fork_plans]
    assert len(loop.reuse) == len(ns.reuse)


def test_render_sample_matches_jax():
    rng = np.random.default_rng(0)
    n = 3
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    planes = (rng.random((n, 19, 19, 15)) < 0.3).astype(np.float32)
    scalars = f(n, 8)
    outs = dict(pi_logits=f(n, 362), outcome_probs=rng.dirichlet([1, 1], n).astype(np.float32),
                score_probs=rng.dirichlet(np.ones(800), n).astype(np.float32),
                q6=f(n), q16=f(n), q50=f(n), ownership=f(n, 361))
    tgts = dict(policy=rng.dirichlet(np.ones(362), n).astype(np.float32),
                game_outcome=np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)],
                score=f(n), q6=f(n), q16=f(n), q50=f(n))
    as_t = lambda d: types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in d.items()})
    as_n = lambda d: types.SimpleNamespace(**d)
    for idx in range(n):
        assert render_sample(torch.from_numpy(planes), torch.from_numpy(scalars), as_t(outs),
                             as_t(tgts), idx) == \
            jax_render_sample(planes, scalars, as_n(outs), as_n(tgts), idx)


# ---------------------------------------------------------------- the loop

def test_resume_roundtrip(tmp_path):
    root = str(tmp_path / "run")
    loop = _loop(tmp_path)
    info = loop.run_generation()
    assert info["gen"] == 1
    for name in ("model_0001", "live", "cand", "stats"):
        assert os.path.isdir(os.path.join(root, name)), name
    for name in ("replay.npz", "elo_history.txt", "sel_mult_calib.txt", "resume_meta.json"):
        assert os.path.exists(os.path.join(root, name)), name

    again = _loop(tmp_path)
    assert again.try_resume()
    assert again.gen == 1
    ts, ts2 = loop.train_state, again.train_state
    assert (len(again.replay), again.replay.games_added) == (len(loop.replay),
                                                             loop.replay.games_added)
    assert ts2.step == ts.step > 0 and ts2.opt_state["count"] == ts.opt_state["count"]
    for a, b in ((again.golden.state_dict(), loop.golden.state_dict()),
                 (ts2.params, ts.params), (ts2.batch_stats, ts.batch_stats),
                 (ts2.opt_state["trace"], ts.opt_state["trace"])):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(again.generator.get_state(), loop.generator.get_state())
    assert again.sel_mult_base == loop.sel_mult_base

    assert again.run_generation()["gen"] == 2
    assert os.path.isdir(os.path.join(root, "model_0002"))
    third = _loop(tmp_path)
    assert third.try_resume() and third.gen == 2


def test_try_resume_fresh_dir_is_noop(tmp_path):
    loop = _loop(tmp_path, "fresh", seed=1)
    assert not loop.try_resume()
    assert loop.gen == 0


def _examples(n: int, seed: int) -> GameExamples:
    rng = np.random.default_rng(seed)
    return GameExamples(
        stones=rng.integers(-1, 2, (n, 361)).astype(np.int8),
        last_moves=rng.integers(0, 362, (n, 5)).astype(np.int16),
        color=np.where(np.arange(n) % 2 == 0, 1, -1).astype(np.int8),
        komi=np.full(n, 7.5, np.float32),
        pi=rng.dirichlet(np.ones(362), n).astype(np.float32),
        pi_aux=rng.integers(0, 362, n).astype(np.int16),
        pi_aux_dist=np.full((n, 362), 1 / 362, np.float32),
        has_pi_aux_dist=np.ones(n, bool), own=rng.integers(-1, 2, (n, 361)).astype(np.int8),
        score_margin=rng.normal(0, 5, n).astype(np.float32),
        z=rng.choice([-1.0, 1.0], n).astype(np.float32),
        q6=np.zeros(n, np.float32), q16=np.zeros(n, np.float32), q50=np.zeros(n, np.float32),
        q6_score=np.zeros(n, np.float32), q16_score=np.zeros(n, np.float32),
        q50_score=np.zeros(n, np.float32), weight=np.ones(n, np.float32),
        mcts_value_dist=np.zeros((n, 51), np.uint16))


def test_replay_save_load_roundtrip(tmp_path):
    buf = ReplayBuffer(capacity=64, seed=0)
    for g in range(3):
        buf.add_game(_examples(10, g))
    path = str(tmp_path / "replay.npz")
    buf.save(path)
    buf2 = ReplayBuffer(capacity=64, seed=9)
    buf2.load(path)
    assert (len(buf2), buf2.total_added, buf2.games_added) == \
        (len(buf), buf.total_added, buf.games_added)
    # identical rng state -> identical future samples
    s1, s2 = buf.sample(8), buf2.sample(8)
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k])


def _outputs(model, loop):
    from p3achygo_tpu_torch.features import batched_features

    planes, scalars = batched_features(loop.states)
    with torch.no_grad():
        return model(planes, scalars).pi_logits.clone()


def test_training_leaves_the_golden_unchanged(tmp_path):
    loop = _loop(tmp_path)
    for g in range(3):
        loop.replay.add_game(_examples(12, g))
    rng = np.random.default_rng(2)
    stones = np.where(rng.random((4, 361)) < 0.3, rng.choice([1, -1], (4, 361)), 0)
    loop.states = from_stones(stones, 7.5, 1, device="cpu")
    golden0, live0 = _outputs(loop.golden, loop), _outputs(loop.model, loop)
    loop.train_epoch(2)
    assert torch.equal(_outputs(loop.golden, loop), golden0)
    assert not torch.allclose(_outputs(loop.model, loop), live0)
    # Promotion copies the live weights into the golden, not the module.
    loop.golden.load_state_dict(loop.model.state_dict())
    assert torch.equal(_outputs(loop.golden, loop), _outputs(loop.model, loop))
    assert loop.golden is not loop.model


def test_momentum_and_lr_across_generations(tmp_path):
    """train_and_gate keeps the Nesterov trace, and the next generation's
    first step uses lr_for_gen of that generation."""
    loop = _loop(tmp_path, lr=1e-2, lr_schedule=[(0, 1e-2), (1, 3e-3)],
                 lr_transition_window=0)
    for g in range(3):
        loop.replay.add_game(_examples(12, g))
    loop.train_and_gate(eval_gating=False)
    assert loop.gen == 1 and loop.lr == lr_for_gen(loop.cfg, 0) == 1e-2
    t0 = {k: v.clone() for k, v in loop.train_state.opt_state["trace"].items()}
    assert any(bool(v.abs().sum() > 0) for v in t0.values())
    p0 = {k: v.detach().clone() for k, v in loop.train_state.params.items()}
    count0 = loop.train_state.opt_state["count"]
    loop.lr = lr_for_gen(loop.cfg, loop.gen)  # what train_and_gate sets first
    loop.train_epoch(1)
    assert loop.train_state.opt_state["count"] == count0 + 1
    # sgd_nesterov: t1 = g + mu t0, update = -lr (g + mu t1).
    mu = 0.9
    name = max(t0, key=lambda k: float(t0[k].abs().max()))
    t1 = loop.train_state.opt_state["trace"][name]
    step = loop.train_state.params[name].detach() - p0[name]
    u = (t1 - mu * t0[name]) + mu * t1
    big = u.abs() > 0.1 * u.abs().max()
    lr = (-step[big] / u[big]).double()
    np.testing.assert_allclose(lr.numpy(), 3e-3, rtol=1e-3)
    info = loop.train_and_gate(eval_gating=False)
    assert info["lr"] == 3e-3 and loop.gen == 2


def test_unported_search_options_raise_at_bind(tmp_path):
    """The search options that once raised at bind now run: a generation of
    config/ci-tiny.json (early stopping) with exact terminal scoring and
    the value-bias cache, whose table the self-play steps fill (ci-tiny
    as it is: test_cli_runs_ci_tiny)."""
    from p3achygo_tpu_torch.mcts import gumbel as tg
    from p3achygo_tpu_torch.rl import loop as rl_loop

    cfg = tconfig.parse(os.path.join(ROOT, "config", "ci-tiny.json"))
    assert cfg.early_stopping_enabled
    for name, kw in (("exact_bias", dict(terminal_mode="exact", bias_cache_lambda=0.5)),):
        loop = GenerationLoop(dataclasses.replace(cfg, **kw), root_dir=str(tmp_path / name),
                              dtype=torch.float32, device="cpu", seed=1)
        used = []
        real = rl_loop.selfplay_step_tiered

        def spy(*a, **k):
            out = real(*a, **k)
            if loop.bias is not None:
                used.append(int(out[-1].used.sum()))
            return out
        tg.COUNTERS.reset()
        rl_loop.selfplay_step_tiered = spy
        try:
            info = loop.run_generation()
        finally:
            rl_loop.selfplay_step_tiered = real
        assert info["gen"] == 1 and os.path.isdir(os.path.join(loop.root, "model_0001"))
        snap = tg.COUNTERS.snapshot()
        assert snap["syncs"]["early_stop"] > 0, snap
        assert loop.bias.key0.shape == (cfg.selfplay_batch_size, 1024)
        assert max(used) > 0 and snap["syncs"]["exact_terminal"] > 0


def test_resume_keeps_no_bias_table(tmp_path):
    """JAX's save_resume / try_resume carry no bias table: a resumed loop
    starts from an empty one of the configured size (in-flight games, whose
    knowledge the table holds, are lost at a crash)."""
    loop = _loop(tmp_path, bias_cache_lambda=0.5, terminal_mode="exact")
    loop.run_generation()
    loop.bias = loop.bias._replace(used=torch.ones_like(loop.bias.used))
    loop.save_resume()
    again = _loop(tmp_path, bias_cache_lambda=0.5, terminal_mode="exact")
    assert again.try_resume() and again.gen == 1
    assert again.bias.key0.shape == loop.bias.key0.shape
    assert all(int(t.abs().sum()) == 0 for t in again.bias)
    template = set(JaxLoop._resume_template(types.SimpleNamespace(
        train_state=types.SimpleNamespace(params=0, batch_stats=0, opt_state=0, step=0),
        golden={"params": 0, "batch_stats": 0}, key=0, sel_mult_base=0)))
    assert not any("bias" in k for k in template)


def test_harvest_clears_bias_rows_like_jax(finished_games, tmp_path):
    """_harvest resets the finished boards' rows of the bias table, as the
    JAX loop's does."""
    from p3achygo_tpu.mcts import bias as jb

    B, T, states, buf = finished_games
    seed = 4
    kw = dict(selfplay_batch_size=B, selfplay_max_game_len=T, fork_enabled=False,
              bias_cache_lambda=0.5)
    jcfg = jconfig.RunConfig(**{**dataclasses.asdict(jax_tiny_run_cfg()), **kw})
    ns = _jax_namespace(None, None, jcfg, states, buf, B, T, seed, None)
    ns.fork = None
    rng = np.random.default_rng(3)
    filled = jb.make_bias_table(B, 1024)._replace(
        used=jnp.asarray((rng.random((B, 1024)) < 0.3).astype(np.int8)),
        err_sum=jnp.asarray(rng.normal(0, 1, (B, 1024)).astype(np.float32)))
    ns.bias = filled
    loop = _loop(tmp_path, seed=seed, **kw)
    loop.states = state_to_torch(states)
    loop.buf = tl.GameBuffer(**{f: torch.tensor(np.asarray(getattr(buf, f)))
                                for f in tl.GameBuffer._fields})
    loop.tree = tree_to_torch(ns.tree)
    loop.bias = type(loop.bias)(*(torch.tensor(to_np(t)) for t in filled))
    done = np.array(jl.finished_mask(states, ns.sp_cfg))
    done[2] = False
    ns._harvest(done)
    loop._harvest(done)
    for f, a, b in zip(type(loop.bias)._fields, ns.bias, loop.bias):
        np.testing.assert_array_equal(b.numpy(), to_np(a), err_msg=f)
    assert int(loop.bias.used[~torch.from_numpy(done)].sum()) > 0
    assert int(loop.bias.used[torch.from_numpy(done)].sum()) == 0


def test_cli_runs_ci_tiny(tmp_path, monkeypatch, capsys):
    """python -m p3achygo_tpu_torch.rl on config/ci-tiny.json (early
    stopping on) runs one generation and exits 0 (run as `-m` does, in
    this process: a second interpreter would compete with the test
    workers for the cores)."""
    import runpy
    import sys

    monkeypatch.setattr(sys, "argv", [
        "p3achygo_tpu_torch.rl", "--config", os.path.join(ROOT, "config", "ci-tiny.json"),
        "--gens", "1", "--device", "cpu", "--run-dir", str(tmp_path / "cli")])
    monkeypatch.delitem(sys.modules, "p3achygo_tpu_torch.rl.__main__", raising=False)
    try:
        runpy.run_module("p3achygo_tpu_torch.rl", run_name="__main__", alter_sys=True)
    except SystemExit as e:  # argparse and the like exit; a clean run returns
        assert e.code in (0, None), e.code
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["gen"] == 1


def test_validate_writes_a_rendered_sample(tmp_path):
    loop = _loop(tmp_path)
    loop.val_replay.add_game(_examples(10, 4))
    out = loop.validate()
    assert np.isfinite(out["val_loss"]) and 0.0 <= out["val_policy_acc"] <= 1.0
    with open(os.path.join(loop.root, "train_samples.txt")) as f:
        text = f.read()
    assert "# generation 0" in text and "TRAIN SAMPLE" in text


def test_main_runs_one_generation(tmp_path, capsys):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(dataclasses.asdict(tiny_run_cfg())))
    run_dir, sgf_dir = tmp_path / "cli", tmp_path / "cli_sgf"
    main(["--config", str(path), "--gens", "1", "--run-dir", str(run_dir), "--device", "cpu",
          "--sgf-dir", str(sgf_dir), "--seed", "2"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[-1]["gen"] == 1 and lines[-1]["games"] == 2 and "wall_s" in lines[-1]
    assert os.listdir(sgf_dir)
    # A second call resumes at gen 1 and has nothing left to run.
    main(["--config", str(path), "--gens", "1", "--run-dir", str(run_dir), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == {"resumed_at_gen": 1}
    # The distributed roles run over a store bus: without --store, an error.
    for role in ("actor", "learner"):
        with pytest.raises(SystemExit):
            main(["--config", str(path), "--role", role, "--device", "cpu"])
        assert "requires --store" in capsys.readouterr().err
