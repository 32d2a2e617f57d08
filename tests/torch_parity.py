"""Helpers for the parity tests of the PyTorch port against the JAX package:
moving batched states and trees between the two, random legal play, and
short JAX self-play runs."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p3achygo_tpu.game.board import legal_mask as jax_legal_mask
from p3achygo_tpu.game.board import new_state as jax_new_state
from p3achygo_tpu.game.board import step as jax_step
from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.selfplay import loop as jl
from p3achygo_tpu_torch.game.board import GoState
from p3achygo_tpu_torch.mcts.tree import Tree

_STATE_DTYPES = {
    "stones": torch.int8, "chain_id": torch.int32, "hash": torch.int64,
    "history": torch.int64, "history_len": torch.int32,
    "last_moves": torch.int32, "to_move": torch.int8, "ko_point": torch.int32,
    "consecutive_passes": torch.int32, "passes": torch.int32,
    "move_count": torch.int32, "komi": torch.float32,
    "num_b_prisoners": torch.int32, "num_w_prisoners": torch.int32,
    "pass_alive": torch.int8, "pa_move": torch.int32,
}

_JAX_UINT32 = ("hash", "history", "s_hash")


def to_np(x) -> np.ndarray:
    """Array -> numpy; uint32 hash lanes widen to int64 like the port's."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return a


def numpy_vars(variables, rng=None):
    """flax variables -> numpy; with `rng`, BN statistics and affine
    parameters are perturbed so the BN fold is not an identity."""
    def conv(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v)
                continue
            a = np.asarray(v, np.float32)
            if rng is not None and k in ("mean", "bias", "scale"):
                a = a + rng.normal(0, 0.1, a.shape).astype(np.float32)
            elif rng is not None and k == "var":
                a = a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            out[k] = a
        return out
    return {"params": conv(variables["params"]),
            "batch_stats": conv(variables["batch_stats"])}


def state_to_torch(js) -> GoState:
    """Batched JAX GoState -> port GoState (CPU tensors)."""
    return GoState(**{f: torch.tensor(to_np(getattr(js, f))).to(_STATE_DTYPES[f])
                      for f in GoState._fields})


def tree_to_torch(jt) -> Tree:
    """JAX Tree -> port Tree (uint32 fields widen to int64)."""
    out = {}
    for f in Tree._fields:
        a = np.asarray(getattr(jt, f))
        if a.dtype == np.uint32:
            out[f] = torch.tensor(a.astype(np.int64))
        elif str(a.dtype) == "bfloat16":
            out[f] = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
        else:
            out[f] = torch.tensor(a)
    return Tree(**out)


def assert_tree_equal(jt, tt: Tree, float_atol: float = 1e-5,
                      fields=Tree._fields):
    """Integer fields exact, float fields within float_atol."""
    for f in fields:
        a = to_np(getattr(jt, f))
        b = getattr(tt, f)
        b = (b.float() if b.dtype == torch.bfloat16 else b).numpy()
        if str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=float_atol, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


_jit_step = jax.jit(jax.vmap(jax_step))
_jit_legal = jax.jit(jax.vmap(jax_legal_mask))


def random_jax_states(B: int, moves: int, seed: int, pass_prob: float = 0.0):
    """B JAX boards after `moves` plies of random legal play."""
    rng = np.random.default_rng(seed)
    states = jax.vmap(lambda _: jax_new_state())(jnp.arange(B))
    for _ in range(moves):
        masks = np.asarray(_jit_legal(states))
        acts = np.array([rng.choice(np.flatnonzero(m[:361]))
                         if rng.random() >= pass_prob else 361
                         for m in masks], np.int32)
        states, _ = _jit_step(states, jnp.asarray(acts))
    return states


def toy_eval_fn(states):
    """A network-free JAX evaluator whose priors, value and score depend on
    the position, so root values (and TD targets) vary along a game."""
    lead = jnp.sum(states.stones.astype(jnp.float32), axis=1) \
        * states.to_move.astype(jnp.float32)
    phase = states.hash[:, 0].astype(jnp.float32) * 1e-9
    logits = jnp.sin(jnp.arange(362, dtype=jnp.float32)[None, :] * 0.37
                     + lead[:, None] + phase[:, None])
    return jg.EvalOutput(log_priors=jax.nn.log_softmax(2.0 * logits),
                         outcome_value=jnp.tanh(0.3 * lead + jnp.sin(phase)),
                         score_est=2.0 * lead, score_var=jnp.ones_like(lead))


def jax_selfplay_games(B: int, T: int, plies: int, seed: int = 1):
    """(states, buf) of B JAX games after `plies` single-tier self-play
    steps with `toy_eval_fn`, an n=4/k=2 search and a T-move cap; every move
    is trainable (force_sel), no raw-policy openings."""
    cfg = jl.SelfplayConfig(batch_size=B, max_game_len=T, max_raw_policy_moves=0)
    params = jg.SearchParams(n=4, k=2, max_depth=6)
    step = jax.jit(functools.partial(jl.selfplay_step, eval_fn=toy_eval_fn,
                                     params=params, cfg=cfg, selected_tier=True))
    states = jax.vmap(lambda _: jax_new_state(7.5))(jnp.arange(B))
    buf = jl.make_game_buffer(B, T)
    aux = jl.make_aux(jax.random.PRNGKey(seed), B, 0)
    key = jax.random.PRNGKey(seed + 1)
    for _ in range(plies):
        aux = aux._replace(force_sel=jnp.ones((B,), bool))
        states, buf, aux, key = step(states, buf, aux, key)
    return states, buf


def tiny_pair(seed: int):
    """(flax `tiny` model, its variables as jnp arrays, the port's `tiny`
    model in float32 with the same weights). The weights are the port's
    seeded init carried to flax (no JAX init to compile), sharpened as
    tests/test_torch_selfplay.py does: a random tiny net's policy is near
    uniform and its score head sits on an end bin."""
    from p3achygo_tpu.models import build_model as jax_build
    from p3achygo_tpu.models import get_config as jax_get_config
    from p3achygo_tpu_torch.bridge import load_flax_variables, state_dict_to_flax
    from p3achygo_tpu_torch.models.config import get_config
    from p3achygo_tpu_torch.models.model import build_model, init_params

    tm = build_model(get_config("tiny"), device="cpu")
    init_params(tm, torch.Generator().manual_seed(seed))
    np_vars = state_dict_to_flax(tm.state_dict())
    np_vars["params"]["policy_head"]["output_moves"]["kernel"] *= 30.0
    np_vars["params"]["value_head"]["outcome_q_output"]["kernel"] *= 10.0
    np_vars["params"]["value_head"]["score_pre_s"] *= 0.02
    load_flax_variables(tm, np_vars)
    return (jax_build(jax_get_config("tiny")),
            jax.tree_util.tree_map(jnp.asarray, np_vars), tm)
