"""Fused serving trunk v2 (port of p3achygo_tpu/nn/trunk_kernel2.py).

Each run of consecutive bottleneck blocks is one launch of the same segment
kernel as v1 (`ops/trunk.py` `trunk_segment`); the broadcast blocks run
between the segment calls as plain PyTorch, as the JAX version leaves them
to XLA (`_bc_block_xla`). They round as that function does: the position
mix z stays float32 until conv_last's affine, where v1 rounds it to bf16.
The TPU layout of v2 (368-row padding, 16 boards interleaved per grid
step) is not carried over.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from p3achygo_tpu_torch.constants import NUM_LOCS
from p3achygo_tpu_torch.models.blocks import mish_f32
from p3achygo_tpu_torch.models.model import P3achyGoModel
from p3achygo_tpu_torch.nn.trunk_kernel import (
    Segment,
    _plan_segments,
    block_arrays,
    build_trunk_weights,
    trunk_fn_of,
    trunk_segments,
)

__all__ = ["_plan_segments", "build_trunk_weights_v2", "build_trunk_fn_v2",
           "bc_block_v2"]


def _v2_mix(arrs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A broadcast block's v1 arrays with WdT [384, 384] replaced by Wd
    [361, 361] un-transposed (Wd[p, q]: source position p -> destination
    q, the Dense kernel), unpadded, for the plain einsum."""
    return arrs[:3] + [arrs[3][:NUM_LOCS, :NUM_LOCS].t().contiguous()] + arrs[4:]


@torch.no_grad()
def build_trunk_weights_v2(config, model: P3achyGoModel
                           ) -> Tuple[Tuple[str, ...], List[torch.Tensor]]:
    """Like `build_trunk_weights`, with each broadcast block's mix as
    `_v2_mix` gives it (trunk_kernel2.py:194-226 without its padding)."""
    kinds, arrs = build_trunk_weights(config, model)
    out: List[torch.Tensor] = []
    for kind, blk in zip(kinds, block_arrays(config, kinds, arrs)):
        out.extend(_v2_mix(blk) if kind == "bc" else blk)
    return kinds, out


def bc_block_v2(x: torch.Tensor, arrs: List[torch.Tensor]) -> torch.Tensor:
    """One broadcast block on x [N, 361, C] bf16 (`_bc_block_xla` with bf16
    operands and f32 products): arrs = (f_a, f_b, Wf, Wd, bd, l_a, l_b, Wl)."""
    f_a, f_b, wf, wd, bd, l_a, l_b, wl = arrs
    bf = lambda t: t.to(torch.bfloat16).float()
    h = bf(mish_f32(x.float() * f_a + f_b)) @ wf.float()
    m = bf(mish_f32(h))
    z = torch.matmul(wd.float().t(), m) + bd[:, None]
    y = bf(mish_f32(z * l_a + l_b)) @ wl.float()
    return (x.float() + y).to(torch.bfloat16)


def build_trunk_fn_v2(config, model: P3achyGoModel):
    """-> trunk_fn for `P3achyGoModel.forward(..., trunk_fn=...)`:
    bottleneck runs on the segment kernel, broadcast blocks as plain
    PyTorch (`bc_block_v2`); `trunk_reference(x, trunk_fn.segments)` is
    its plain trunk."""
    return trunk_fn_of(trunk_segments(
        config, model, lambda arrs: Segment(bc_block_v2, bc_block_v2, _v2_mix(arrs))))
