"""Fused serving trunk (port of p3achygo_tpu/nn/trunk_kernel.py).

The residual trunk of a btl network runs in hand-written kernels: each run
of consecutive bottleneck blocks is one launch of the segment kernel and
each broadcast block one launch of the broadcast kernel
(`ops/trunk.py`, `csrc/trunk_broadcast.cu`), alternating on
`_plan_segments`' plan.
Every BatchNorm is folded to a per-channel affine (a, b) followed by the
two-branch `mish_f32`; 1x1 convolutions are [Cin, Cout] matrices and each
3x3 one [9*Cb, Cb] matrix in OFFSETS order. The stem and the heads stay
the plain model (`P3achyGoModel.forward(..., trunk_fn=...)`).

Rounding follows the JAX kernel: bf16 activations between layers, f32
accumulation, the residual added in f32 and rounded to bf16, the broadcast
mix rounded to bf16 before conv_last's affine. The TPU's batch tiles of
`n_tile` are not carried over: a board is [361, C] channels-last and the
batch is not padded; only the mix's WdT keeps JAX's 384-row padding, which
is the broadcast kernel's six 64-row M tiles.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch

from p3achygo_tpu_torch.constants import NUM_LOCS
from p3achygo_tpu_torch.models.blocks import ConvBlock
from p3achygo_tpu_torch.models.model import P3achyGoModel, block_name, is_broadcast_block
from p3achygo_tpu_torch.ops.trunk import (
    MAX_INNER,
    MIX_PAD,
    SEGMENT_WIDTHS,
    BROADCAST_WIDTHS,
    BroadcastWeights,
    SegmentWeights,
    pack_broadcast,
    pack_segment,
    trunk_broadcast,
    trunk_broadcast_reference,
    trunk_segment,
    trunk_segment_reference,
)

BOARD = 19
# 3x3 neighbourhood offsets (di, dj); W9 row block o multiplies the input
# at (i + di, j + dj).
OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]

class Segment(NamedTuple):
    """One step of a fused trunk: `kernel(x, weights)` on the card, its
    plain version `reference(x, weights)` for the plain trunk; both map
    x [N, 361, C] bf16 to a new tensor of the same shape."""

    kernel: Callable
    reference: Callable
    weights: Any


def trunk_supported(config) -> bool:
    """The fused trunk covers btl trunks with broadcast blocks (the JAX
    rule, trunk_kernel.py:47). Which widths the kernels take is the
    kernels' own check, on the card."""
    return (not getattr(config, "is_transformer", False)
            and config.trunk_block_type == "btl")


def _plan_segments(kinds: Sequence[str]) -> List[Tuple[str, int, int]]:
    """[(kind, start_block, n_blocks)] with consecutive btl runs merged."""
    plan: List[Tuple[str, int, int]] = []
    i = 0
    while i < len(kinds):
        if kinds[i] == "btl":
            j = i
            while j < len(kinds) and kinds[j] == "btl":
                j += 1
            plan.append(("btl", i, j - i))
            i = j
        else:
            plan.append(("bc", i, 1))
            i += 1
    return plan


def _conv_block_w(cb: ConvBlock) -> List[torch.Tensor]:
    """[a, b, W] of one ConvBlock: a, b f32 [Cin]; W bf16 [Cin, Cout] for a
    1x1, [9 * Cin, Cout] in OFFSETS order for a 3x3. The conv weight is
    OIHW, so tap (di, dj) is weight[:, :, di + 1, dj + 1] transposed."""
    a, b = cb.BatchNorm_0.affine()
    w = cb.Conv_0.weight.detach().float()
    if w.shape[-1] == 1:
        wm = w[:, :, 0, 0].t()
    else:
        wm = torch.cat([w[:, :, di + 1, dj + 1].t() for di, dj in OFFSETS], dim=0)
    return [a.detach().float(), b.detach().float(), wm.to(torch.bfloat16)]


@torch.no_grad()
def build_trunk_weights(config, model: P3achyGoModel
                        ) -> Tuple[Tuple[str, ...], List[torch.Tensor]]:
    """The trunk's folded weights as (block kinds, flat arrays), in the JAX
    order (trunk_kernel.py:84-120). Per btl block: r_a, r_b, Wr,
    [i_a, i_b, W9] * inner, e_a, e_b, We. Per broadcast block: f_a, f_b,
    Wf, WdT [384, 384] bf16 (WdT[q, p] = Dense kernel[p, q], zero-padded to
    the kernel's tiles), bd [361] f32, l_a, l_b, Wl."""
    kinds: List[str] = []
    arrs: List[torch.Tensor] = []
    for i in range(config.blocks):
        blk = getattr(model, block_name(config, i))
        if is_broadcast_block(config, i):
            kinds.append("bc")
            arrs.extend(_conv_block_w(blk.conv_first))
            dense = blk.mix.Dense_0  # weight [out q, in p] = kernel[p, q]
            wdt = torch.zeros((MIX_PAD, MIX_PAD), dtype=torch.float32,
                              device=dense.weight.device)
            wdt[:NUM_LOCS, :NUM_LOCS] = dense.weight.detach().float()
            arrs.append(wdt.to(torch.bfloat16))
            arrs.append(dense.bias.detach().float().clone())
            arrs.extend(_conv_block_w(blk.conv_last))
        else:
            kinds.append("btl")
            arrs.extend(_conv_block_w(blk.reduce))
            for j in range(blk.inner):
                arrs.extend(_conv_block_w(getattr(blk, f"inner_{j}")))
            arrs.extend(_conv_block_w(blk.expand))
    return tuple(kinds), arrs


def _pack_segment(blocks: List[List[torch.Tensor]], channels: int
                  ) -> SegmentWeights:
    """Per-block flat arrays -> the segment kernel's stacked weights, with
    the kernel's weight stream (`pack_segment`, once, here) for the widths
    it takes."""
    affs, wr, w9, we = [], [], [], []
    for arrs in blocks:
        layers = [arrs[k:k + 3] for k in range(0, len(arrs), 3)]
        aff = torch.zeros((len(layers), 2, channels), dtype=torch.float32,
                          device=arrs[0].device)
        for li, (a, b, _) in enumerate(layers):
            aff[li, 0, :a.shape[0]] = a
            aff[li, 1, :b.shape[0]] = b
        affs.append(aff)
        wr.append(layers[0][2])
        cb = layers[0][2].shape[1]
        w9.append(torch.stack([w for _, _, w in layers[1:-1]]) if len(layers) > 2
                  else layers[0][2].new_zeros((0, 9 * cb, cb)))
        we.append(layers[-1][2])
    w = SegmentWeights(torch.stack(affs).contiguous(),
                       torch.stack(wr).contiguous(),
                       torch.stack(w9).contiguous(),
                       torch.stack(we).contiguous())
    if tuple(w.wr.shape[1:]) in SEGMENT_WIDTHS and w.w9.shape[1] <= MAX_INNER:
        w = w._replace(packed=pack_segment(w))
    return w


def _pack_broadcast(arrs: List[torch.Tensor]) -> BroadcastWeights:
    """One broadcast block's flat arrays -> BroadcastWeights, with the
    kernel's packed weights (`pack_broadcast`, once, here) for the widths
    it takes."""
    f_a, f_b, wf, wdt, bd, l_a, l_b, wl = arrs
    w = BroadcastWeights(torch.stack([f_a, f_b]).contiguous(), wf.contiguous(),
                         wdt.contiguous(), bd.contiguous(),
                         torch.stack([l_a, l_b]).contiguous(), wl.contiguous())
    if wf.shape[0] in BROADCAST_WIDTHS:
        w = w._replace(packed=pack_broadcast(w))
    return w


def block_arrays(config, kinds, arrs) -> List[List[torch.Tensor]]:
    """Split the flat array list into one list per block."""
    per_btl = 3 * (2 + config.inner_bottleneck_layers)
    out, ai = [], 0
    for kind in kinds:
        n = per_btl if kind == "btl" else 8
        out.append(arrs[ai:ai + n])
        ai += n
    assert ai == len(arrs)
    return out


def trunk_segments(config, model: P3achyGoModel, broadcast: Callable
                   ) -> List[Segment]:
    """The plan's steps, weights on the model's device: the segment kernel
    for each bottleneck run; `broadcast(per_block_arrays)` -> Segment for
    each broadcast block."""
    kinds, arrs = build_trunk_weights(config, model)
    per_block = block_arrays(config, kinds, arrs)
    segments: List[Segment] = []
    for kind, start, n in _plan_segments(kinds):
        if kind == "btl":
            segments.append(Segment(trunk_segment, trunk_segment_reference,
                                    _pack_segment(per_block[start:start + n],
                                                  config.channels)))
        else:
            segments.append(broadcast(per_block[start]))
    return segments


def run_segments(x: torch.Tensor, segments: Sequence[Segment],
                 plain: bool = False) -> torch.Tensor:
    """x [N, 19, 19, C] (any float dtype) -> [N, 19, 19, C] bf16 through the
    segments' kernels (or, with `plain`, their plain versions)."""
    n, channels = x.shape[0], x.shape[-1]
    h = x.reshape(n, NUM_LOCS, channels).to(torch.bfloat16).contiguous()
    for seg in segments:
        h = (seg.reference if plain else seg.kernel)(h, seg.weights)
    return h.reshape(n, BOARD, BOARD, channels)


def trunk_reference(x: torch.Tensor, segments: Sequence[Segment]) -> torch.Tensor:
    """The plain trunk: the plain version of every step of `segments` (a
    trunk_fn's `.segments`), on whatever device x is, rounding at exactly
    the kernels' points."""
    return run_segments(x, segments, plain=True)


def trunk_fn_of(segments: List[Segment]):
    """-> trunk_fn(x [N, 19, 19, C]) -> [N, 19, 19, C] bf16 running
    `segments` (kept as `trunk_fn.segments`). On a CUDA tensor every step
    runs its kernel, on a CPU tensor its plain version; N = 0 launches
    nothing."""
    def trunk_fn(x: torch.Tensor) -> torch.Tensor:
        return run_segments(x, segments)

    trunk_fn.segments = segments
    return trunk_fn


def build_trunk_fn(config, model: P3achyGoModel):
    """-> trunk_fn for `P3achyGoModel.forward(..., trunk_fn=...)`: the
    folded weights (once, here) on the segment and broadcast kernels."""
    return trunk_fn_of(trunk_segments(
        config, model, lambda arrs: Segment(trunk_broadcast,
                                            trunk_broadcast_reference,
                                            _pack_broadcast(arrs))))
