"""The port's actor-learner slice (p3achygo_tpu_torch/rl/slice.py) on the
CPU: the invariants tests/test_e2e_slice.py holds the JAX RLSlice to; the
harvest of one JAX self-play buffer, converted, giving the same replay
rows as JAX's `_harvest`; and self-play serving the new weights after
`train_steps`."""
import dataclasses
import functools
import types

import jax
import numpy as np
import torch

from p3achygo_tpu.data.replay import ReplayBuffer as JaxReplay
from p3achygo_tpu.mcts.gumbel import SearchParams as JaxSearchParams
from p3achygo_tpu.mcts.tree import make_tree as jax_make_tree
from p3achygo_tpu.rl.slice import RLSlice as JaxSlice
from p3achygo_tpu.rl.slice import SliceConfig as JaxSliceConfig
from p3achygo_tpu.selfplay.loop import SelfplayConfig as JaxSelfplayConfig
from p3achygo_tpu.selfplay.loop import final_scores as jax_final_scores
from p3achygo_tpu.selfplay.loop import finished_mask as jax_finished_mask
from p3achygo_tpu.selfplay.loop import make_aux as jax_make_aux
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.mcts.gumbel import SearchParams
from p3achygo_tpu_torch.rl.slice import RLSlice, SliceConfig
from p3achygo_tpu_torch.selfplay.loop import GameBuffer, SelfplayConfig
from torch_parity import jax_selfplay_games, state_to_torch, tree_to_torch

torch.set_num_threads(2)


def _cfg(search_cls, selfplay_cls, slice_cls):
    """tests/test_e2e_slice.py's tiny configuration."""
    return slice_cls(
        model="tiny", batch_size=4, train_batch_size=8,
        search=search_cls(n=4, k=2, noise_scale=1.0, max_depth=8),
        selfplay=selfplay_cls(batch_size=4, max_game_len=12, tau_initial=1.0,
                              tau_min=0.5, max_raw_policy_moves=2),
        lr=1e-3, dtype="float32", seed=3)


def tiny_cfg() -> SliceConfig:
    return _cfg(SearchParams, SelfplayConfig, SliceConfig)


def test_selfplay_to_train_roundtrip():
    slice_ = RLSlice(tiny_cfg(), device="cpu")
    # 12-move cap: all 4 games finish within 14 plies.
    assert slice_.play_moves(14) >= 4
    assert len(slice_.replay) > 0 and slice_.replay.games_added >= 4

    batch = slice_.replay.sample(8)
    assert batch["pi"].shape == (8, 362)
    np.testing.assert_allclose(batch["pi"].sum(-1), 1.0, atol=1e-4)
    assert set(np.unique(batch["z"])) <= {-1.0, 1.0}
    assert np.isfinite(batch["q6"]).all() and (np.abs(batch["q6"]) <= 1.0 + 1e-5).all()

    losses = slice_.train_steps(2)
    assert np.isfinite(losses["loss"]) and losses["grad_norm"] > 0
    assert slice_.train_state.step == 2
    # Self-play goes on against the updated weights.
    assert slice_.play_moves(14) >= 4


def test_harvest_matches_jax():
    """Finished JAX games, converted to the port's tensors, harvest into the
    same replay rows as the JAX slice's `_harvest`: Benson scores,
    ownership and records all agree."""
    cfg = _cfg(JaxSearchParams, JaxSelfplayConfig, JaxSliceConfig)
    T = cfg.selfplay.max_game_len
    states, buf = jax_selfplay_games(cfg.batch_size, T, T)
    done = np.array(jax_finished_mask(states, cfg.selfplay))
    done[1] = False  # one board stays in play
    assert done.sum() >= 2
    # JAX's `_harvest` on the attributes it reads (building a whole JAX
    # slice would initialise and compile a network this test never runs).
    jslice = types.SimpleNamespace(
        cfg=cfg, states=states, buf=buf, replay=JaxReplay(capacity=1 << 18, seed=cfg.seed),
        key=jax.random.PRNGKey(0), tree=jax_make_tree(cfg.batch_size, cfg.search.n + 2),
        aux=jax_make_aux(jax.random.PRNGKey(1), cfg.batch_size),
        _score_fn=jax.jit(jax_final_scores))
    jslice._harvest = functools.partial(JaxSlice._harvest, jslice)

    tslice = RLSlice(tiny_cfg(), device="cpu")
    tslice.states = state_to_torch(states)
    tslice.buf = GameBuffer(**{f: torch.tensor(np.asarray(getattr(buf, f)))
                               for f in GameBuffer._fields})
    tslice.tree = tree_to_torch(jslice.tree)
    assert tslice._harvest(torch.from_numpy(done)) == jslice._harvest(done) == done.sum()
    jr, tr = jslice.replay, tslice.replay
    assert (len(tr), tr.games_added) == (len(jr), jr.games_added) and len(tr) > 0
    for f, arr in jr._data.items():
        np.testing.assert_array_equal(tr._data[f][:len(jr)], arr[:len(jr)], err_msg=f)
    # Harvested boards were reset to fresh games, the other kept.
    np.testing.assert_array_equal(tslice.states.move_count.numpy() == 0, done)
    assert not tslice.buf.trainable[torch.from_numpy(done)].any()
    assert tslice.buf.trainable[1].any()


def test_train_steps_serve_the_new_weights():
    slice_ = RLSlice(tiny_cfg(), device="cpu")
    slice_.play_moves(14)
    slice_.refresh_weights()
    planes, scalars = batched_features(slice_.states)
    before = slice_._eval_fn(slice_.states)
    served_before = slice_.model(planes, scalars).pi_logits
    slice_.train_steps(2)
    assert slice_._eval_fn is None  # self-play rebinds before its next ply
    slice_.refresh_weights()
    after = slice_._eval_fn(slice_.states)
    assert not torch.allclose(after.log_priors, before.log_priors)
    assert not torch.allclose(slice_.model(planes, scalars).pi_logits, served_before)


def test_slice_defaults_match_jax():
    j, t = JaxSliceConfig(), SliceConfig()
    assert (t.model, t.batch_size, t.train_batch_size, t.lr, t.dtype, t.seed) == \
        (j.model, j.batch_size, j.train_batch_size, j.lr, j.dtype, j.seed)
    assert (t.search.n, t.search.k, t.search.noise_scale) == (j.search.n, j.search.k,
                                                              j.search.noise_scale)
    assert dataclasses.asdict(t.selfplay) == dataclasses.asdict(j.selfplay)
