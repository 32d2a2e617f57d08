"""Featurizer of the PyTorch port held against the JAX package: planes and
scalars exact, in float32 and bfloat16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.features import batched_features as jax_features
from p3achygo_tpu_torch.features import batched_features
from torch_parity import random_jax_states, state_to_torch

torch.set_num_threads(2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moves,pass_prob", [(0, 0.0), (50, 0.1), (150, 0.02)])
def test_batched_features_exact(dtype, moves, pass_prob):
    js = random_jax_states(B=6, moves=moves, seed=moves + 1, pass_prob=pass_prob)
    js = js._replace(komi=jnp.asarray([7.5, 6.5, 0.5, -3.0, 7.5, 9.0], jnp.float32))
    jp, jsc = jax_features(js, False, planes_dtype=getattr(jnp, dtype))
    tp, tsc = batched_features(state_to_torch(js), False,
                               planes_dtype=getattr(torch, dtype))
    assert tp.dtype == getattr(torch, dtype)
    assert tuple(tp.shape) == (6, 19, 19, 15)
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.asarray(jp).astype(np.float32))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_ladder_planes_not_ported():
    """include_ladders=True (once unported) adds planes 13/14, the own and
    opponent stones of laddered_stones (held against JAX in
    tests/test_torch_ladder.py), and changes no other plane or scalar."""
    from p3achygo_tpu_torch.game.ladder import laddered_stones

    ts = state_to_torch(random_jax_states(B=4, moves=90, seed=3))
    p0, s0 = batched_features(ts, include_ladders=False)
    p1, s1 = batched_features(ts, include_ladders=True)
    lad = laddered_stones(ts).reshape(4, 19, 19)
    assert lad.any()
    np.testing.assert_array_equal(p1[..., :13].numpy(), p0[..., :13].numpy())
    np.testing.assert_array_equal(s1.numpy(), s0.numpy())
    np.testing.assert_array_equal(p1[..., 13].numpy(), (lad & (p0[..., 0] > 0)).numpy())
    np.testing.assert_array_equal(p1[..., 14].numpy(), (lad & (p0[..., 1] > 0)).numpy())
