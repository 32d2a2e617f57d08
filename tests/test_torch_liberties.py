"""Liberty counts of the PyTorch port's plain version held against the JAX
package's Pallas kernel in interpret mode and its XLA reference: exact
integer equality. The CUDA kernel is held against the plain version in
test_torch_cuda.py, on a card."""
import numpy as np
import pytest
import torch

from p3achygo_tpu.game import board_from_dsl
from p3achygo_tpu.ops.liberties import point_liberties_batch as jax_kernel
from p3achygo_tpu.ops.liberties import point_liberties_reference as jax_reference
from p3achygo_tpu_torch.ops import liberties as tl
from torch_parity import random_jax_states

torch.set_num_threads(2)


def _both(stones, chain):
    ref = np.asarray(jax_reference(stones, chain))
    ker = np.asarray(jax_kernel(stones, chain, interpret=True))
    np.testing.assert_array_equal(ker, ref)
    return ref


@pytest.mark.parametrize("B,moves,seed", [(5, 40, 11), (3, 10, 5), (7, 120, 2)])
def test_plain_matches_jax_on_random_boards(B, moves, seed):
    js = random_jax_states(B=B, moves=moves, seed=seed)
    want = _both(js.stones, js.chain_id)
    stones = torch.tensor(np.asarray(js.stones))
    chain = torch.tensor(np.asarray(js.chain_id))
    np.testing.assert_array_equal(tl.point_liberties_reference(stones, chain).numpy(),
                                  want)
    np.testing.assert_array_equal(tl.point_liberties_batch(stones, chain).numpy(),
                                  want)


def test_plain_matches_jax_on_dsl_position():
    st = board_from_dsl(
        """
        x o . . .
        . o o . .
        x x . . .
        """)
    want = _both(st.stones[None], st.chain_id[None])
    got = tl.point_liberties_batch(torch.tensor(np.asarray(st.stones))[None],
                                   torch.tensor(np.asarray(st.chain_id))[None])
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 1]) == 4


def test_cpu_wrapper_does_not_launch():
    before = tl.point_liberties_batch.launches
    stones = torch.zeros((2, 361), dtype=torch.int8)
    chain = torch.full((2, 361), -1, dtype=torch.int32)
    assert int(tl.point_liberties_batch(stones, chain).abs().sum()) == 0
    assert tl.point_liberties_batch.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "mismatch"])
def test_wrapper_rejects_bad_inputs(bad):
    stones = torch.zeros((2, 361), dtype=torch.int8)
    chain = torch.full((2, 361), -1, dtype=torch.int32)
    if bad == "dtype":
        chain = chain.long()
    elif bad == "shape":
        stones, chain = stones[:, :360], chain[:, :360]
    else:
        chain = chain[:1]
    with pytest.raises((TypeError, ValueError)):
        tl.point_liberties_batch(stones, chain)
