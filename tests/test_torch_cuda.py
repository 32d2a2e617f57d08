"""The PyTorch port's CUDA kernel against its plain version, on a card.

Every test here is marked `cuda` and skips where there is no card. The
file imports no JAX, so it also runs on a machine that has a card and nvcc
but no JAX (the repo's conftest imports JAX, hence `--noconftest`):

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from chip_smoke import random_boards
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import legal_mask_batch, map_state
from p3achygo_tpu_torch.ops import liberties as tl

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def boards(device):
    gen = torch.Generator(device=device).manual_seed(3)
    return random_boards(1024, 150, device, gen)


@pytest.mark.parametrize("B", [1, 7, 64, 1024])
def test_kernel_equals_plain(boards, B):
    stones = boards.stones[:B]
    chain = boards.chain_id[:B]
    before = tl.point_liberties_batch.launches
    got = tl.point_liberties_batch(stones, chain)
    torch.cuda.synchronize()
    assert tl.point_liberties_batch.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (B, 361)
    assert torch.equal(got, tl.point_liberties_reference(stones, chain))


def test_empty_batch_launches_nothing(device):
    stones = torch.zeros((0, 361), dtype=torch.int8, device=device)
    chain = torch.zeros((0, 361), dtype=torch.int32, device=device)
    before = tl.point_liberties_batch.launches
    assert tl.point_liberties_batch(stones, chain).shape == (0, 361)
    assert tl.point_liberties_batch.launches == before


def test_rejects_non_contiguous(boards):
    stones = torch.cat([boards.stones[:4]] * 2, dim=1)[:, ::2]
    chain = torch.cat([boards.chain_id[:4]] * 2, dim=1)[:, ::2]
    with pytest.raises(ValueError):
        tl.point_liberties_batch(stones, chain)


def test_callers_on_card_agree_with_cpu(boards):
    """The kernel's two callers on the main path give on the card what the
    plain version gives them on the CPU."""
    sub = map_state(lambda t: t[:64], boards)
    cpu = map_state(lambda t: t.cpu(), sub)
    assert torch.equal(legal_mask_batch(sub).cpu(), legal_mask_batch(cpu))
    planes, scalars = batched_features(sub)
    planes_cpu, scalars_cpu = batched_features(cpu)
    assert torch.equal(planes.cpu(), planes_cpu)
    assert torch.equal(scalars.cpu(), scalars_cpu)
