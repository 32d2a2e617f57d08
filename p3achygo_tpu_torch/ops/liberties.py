"""Per-point chain liberty counts: the hand-written CUDA kernel and its
plain PyTorch version (port of p3achygo_tpu/ops/liberties.py).

The legality mask at every descent level and the featurizer at every leaf
evaluation call `point_liberties_batch`. On a CUDA tensor it launches the
kernel of `csrc/liberties.cu` (one block per board, shared-memory atomics;
the source note says what bounds it) or raises; on a CPU tensor it runs
`point_liberties_reference`. Both give the same integers: the CPU tests
hold the plain version against the JAX package, and `chip_smoke.py` holds
the kernel against the plain version on the card.
"""
from __future__ import annotations

import ctypes

import torch

from p3achygo_tpu_torch.constants import NUM_LOCS
from p3achygo_tpu_torch.game.board import point_liberties
from p3achygo_tpu_torch.ops.cuda_build import load_library

SOURCE = "liberties.cu"


def point_liberties_reference(stones: torch.Tensor,
                              chain_id: torch.Tensor) -> torch.Tensor:
    """Plain version: gather over NEIGHBORS, pairwise dedup, `scatter_add_`
    into [B, 362] per-chain counts, gather back per point."""
    return point_liberties(stones, chain_id)


def _kernel():
    lib = load_library(SOURCE)
    fn = lib.p3_point_liberties
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def point_liberties_batch(stones: torch.Tensor,
                          chain_id: torch.Tensor) -> torch.Tensor:
    """[B, 361] int8 stones + [B, 361] int32 chain ids -> [B, 361] int32
    liberties of each point's chain (0 on empty points)."""
    if stones.dim() != 2 or stones.shape[1] != NUM_LOCS:
        raise ValueError(f"stones must be [B, {NUM_LOCS}], got {tuple(stones.shape)}")
    if chain_id.shape != stones.shape:
        raise ValueError(f"chain_id shape {tuple(chain_id.shape)} != stones "
                         f"shape {tuple(stones.shape)}")
    if stones.dtype != torch.int8 or chain_id.dtype != torch.int32:
        raise TypeError(f"want int8 stones and int32 chain ids, got "
                        f"{stones.dtype} and {chain_id.dtype}")
    if stones.device != chain_id.device:
        raise ValueError(f"stones on {stones.device}, chain ids on {chain_id.device}")
    if stones.device.type == "cpu":
        return point_liberties_reference(stones, chain_id)
    if stones.device.type != "cuda":
        raise ValueError(f"no liberty kernel for device {stones.device}")
    if not (stones.is_contiguous() and chain_id.is_contiguous()):
        raise ValueError("stones and chain ids must be contiguous")
    out = torch.empty_like(chain_id)
    if stones.shape[0] == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(stones.device):
        stream = torch.cuda.current_stream(stones.device).cuda_stream
        rc = fn(stones.data_ptr(), chain_id.data_ptr(), out.data_ptr(),
                stones.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"liberty kernel launch failed: cudaError {rc}")
    point_liberties_batch.launches += 1
    return out


point_liberties_batch.launches = 0
