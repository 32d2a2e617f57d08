"""Fused-trunk kernels: the hand-written CUDA kernels and their plain
PyTorch versions (counterparts of the Pallas kernels of p3achygo_tpu's
nn/trunk_kernel.py `_make_kernel` and nn/trunk_kernel2.py
`_make_segment_kernel`).

Two calls make a trunk of bottleneck and broadcast blocks, on activations
x [N, 361, C] bf16 (channels last, one row per board position):

* `trunk_segment` runs a run of consecutive bottleneck blocks in one
  launch of `csrc/trunk_segment.cu` `p3_trunk_segment` (wgmma, weights
  staged by bulk-async copies, persistent blocks);
* `trunk_broadcast` runs one broadcast block in one launch of
  `csrc/trunk_broadcast.cu` `p3_trunk_broadcast` (wgmma for all three
  products, the position mix streamed by bulk-async copies, persistent
  blocks).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain version (`trunk_segment_reference`,
`trunk_broadcast_reference`), which rounds to bf16 at exactly the kernel's
points and does every product as a float32 product of bf16-rounded
operands (what the Pallas kernels' `preferred_element_type=f32` computes).
On the card the plain versions need TF32 off (`torch.backends.cudnn.
allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`) to be float32.
The kernels' mish divides approximately (csrc/trunk_common.cuh), ~2
f32 ulp from the plain version's IEEE division, which moves a rare bf16
rounding by one unit.
Each wrapper counts its launches in `.launches`.

The segment kernel reads its weights as `pack_segment` lays them out: a
stream of Cb x Cb chunks in the shared-memory layout of the wgmma B operand,
packed once on the host. `unpack_segment` inverts it, and
`segment_tile_positions` / `TAP_SHIFTS` spell out the kernel's M tiling of
the zero-haloed 21x21 grid. The broadcast kernel reads `pack_broadcast`'s
layout (Wf and Wl as B operands, WdT as a stream of A-operand chunks),
inverted by `unpack_broadcast`. The CPU tests hold all of them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.constants import NUM_LOCS
from p3achygo_tpu_torch.models.blocks import mish_f32
from p3achygo_tpu_torch.ops.cuda_build import load_library

SOURCE = "trunk_broadcast.cu"  # the broadcast kernel
SEGMENT_SOURCE = "trunk_segment.cu"
MIX_PAD = 384  # the broadcast kernel's position tiles: 6 x 64 rows
# The broadcast kernel's WdT stream: per M tile of 64 destination positions
# q, chunks of MIX_CHUNK_COLS source positions p (4 KB each).
MIX_CHUNK_COLS = 32
# Widths the kernels take: (channels, bottleneck) for a segment, channels
# for a broadcast block; the segment kernel takes up to MAX_INNER 3x3
# layers a block.
SEGMENT_WIDTHS = ((64, 32), (128, 64))
BROADCAST_WIDTHS = (64, 128)
MAX_INNER = 3

# The segment kernel's geometry: the activated bottleneck tensor of a board
# lives in a zero-haloed 21x21 grid (position (i, j) at row (i+1)*21 + j+1);
# an M tile is 64 interior positions, 6 tiles cover the 361; tap
# o = (di+1)*3 + (dj+1) reads row halo_row(p) + TAP_SHIFTS[o].
HALO_W = 21
HALO_ROWS = HALO_W * HALO_W
TILE_ROWS = 64
SEGMENT_TILES = 6
TAP_SHIFTS = tuple((o // 3 - 1) * HALO_W + (o % 3 - 1) for o in range(9))


class SegmentWeights(NamedTuple):
    """A run of `n_blocks` bottleneck blocks with `inner` 3x3 layers each."""

    aff: torch.Tensor  # f32 [n_blocks, 2 + inner, 2, C]: layer l's (a, b)
    #                    over its input channels (reduce C; inner, expand Cb)
    wr: torch.Tensor  # bf16 [n_blocks, C, Cb] 1x1 reduce, [Cin, Cout]
    w9: torch.Tensor  # bf16 [n_blocks, inner, 9 * Cb, Cb] 3x3 in OFFSETS order
    we: torch.Tensor  # bf16 [n_blocks, Cb, C] 1x1 expand
    packed: Optional[torch.Tensor] = None  # bf16 [n_blocks, chunks, Cb * Cb]:
    #                    `pack_segment` of the above, what the kernel reads
    #                    (needed on the card only)


class BroadcastWeights(NamedTuple):
    """One broadcast block: conv_first, the position mix, conv_last."""

    f_aff: torch.Tensor  # f32 [2, C]
    wf: torch.Tensor  # bf16 [C, C]
    wdt: torch.Tensor  # bf16 [384, 384]: wdt[q, p] = Dense kernel[p, q], 0-padded
    bd: torch.Tensor  # f32 [361]
    l_aff: torch.Tensor  # f32 [2, C]
    wl: torch.Tensor  # bf16 [C, C]
    packed: Optional[torch.Tensor] = None  # bf16 [2 C^2 + 384^2]:
    #                    `pack_broadcast` of the above, what the kernel reads
    #                    (needed on the card only)


def _round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value, as float32."""
    return t.to(torch.bfloat16).float()


def _act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(mish_f32(f32(x) * a + b)) as float32 (`_bn_mish`)."""
    return _round(mish_f32(x.float() * a + b))


def _conv3x3(t: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """3x3 'SAME' convolution of t [N, 361, Cb] (float32) with w9
    [9 * Cb, Cout] in OFFSETS order (row block o = (di+1)*3 + (dj+1)
    multiplies the input at (i+di, j+dj)) -> float32 [N, 361, Cout]."""
    n, _, cb = t.shape
    cout = w9.shape[1]
    weight = w9.float().reshape(3, 3, cb, cout).permute(3, 2, 0, 1)
    y = F.conv2d(t.reshape(n, 19, 19, cb).permute(0, 3, 1, 2), weight, padding=1)
    return y.permute(0, 2, 3, 1).reshape(n, NUM_LOCS, cout)


def trunk_segment_reference(x: torch.Tensor, w: SegmentWeights) -> torch.Tensor:
    """Plain version of `trunk_segment`: bf16 [N, 361, C] -> same."""
    n_blocks, layers = w.aff.shape[:2]
    C, cb = w.wr.shape[1:]
    for blk in range(n_blocks):
        aff = w.aff[blk]
        h = _round(_act(x, aff[0, 0], aff[0, 1]) @ w.wr[blk].float())
        for j in range(layers - 2):
            t = _act(h, aff[1 + j, 0, :cb], aff[1 + j, 1, :cb])
            h = _round(_conv3x3(t, w.w9[blk, j]))
        y = _act(h, aff[-1, 0, :cb], aff[-1, 1, :cb]) @ w.we[blk].float()
        x = (x.float() + y).to(torch.bfloat16)
    return x


def trunk_broadcast_reference(x: torch.Tensor, w: BroadcastWeights) -> torch.Tensor:
    """Plain version of `trunk_broadcast`: bf16 [N, 361, C] -> same."""
    h = _act(x, w.f_aff[0], w.f_aff[1]) @ w.wf.float()
    m = _round(mish_f32(h))
    wdt = w.wdt[:NUM_LOCS, :NUM_LOCS].float()
    z = _round(torch.matmul(wdt, m) + w.bd[:, None])
    y = _act(z, w.l_aff[0], w.l_aff[1]) @ w.wl.float()
    return (x.float() + y).to(torch.bfloat16)


def halo_row(p: torch.Tensor) -> torch.Tensor:
    """Row of position p in the zero-haloed 21x21 grid."""
    return (p // 19 + 1) * HALO_W + p % 19 + 1


def segment_tile_positions() -> torch.Tensor:
    """int64 [6, 64]: the position each row of each M tile computes, -1 for
    the 23 pad rows (which read position 360 and are dropped)."""
    p = torch.arange(SEGMENT_TILES * TILE_ROWS)
    return torch.where(p < NUM_LOCS, p, -1).reshape(SEGMENT_TILES, TILE_ROWS)


def reduce_k_order(channels: int) -> torch.Tensor:
    """int64 [C]: the channel at each K index of the reduce product, and at
    each N index (output column) of the expand. In every 32-channel group,
    lane t4 of a quad loads channels 8*t4 .. +7, which feed logical k (2 t4,
    2 t4 + 1, 2 t4 + 8, 2 t4 + 9) of the group's first k16 step and the same
    of its second; in the expand the same lane holds those channels'
    accumulators, so the next block's reduce reads them from registers."""
    k = torch.arange(channels)
    ks, l = k // 16, k % 16
    return 32 * (ks // 2) + 8 * ((l % 8) // 2) + 4 * (ks % 2) + 2 * (l // 8) + l % 2


def _chunks_per_block(channels: int, cb: int, inner: int) -> int:
    return 2 * (channels // cb) + 9 * inner


def _to_cores(t: torch.Tensor) -> torch.Tensor:
    """[..., R, K] (R, K multiples of 8) -> [..., R * K] in 8x8 core
    matrices of 128 contiguous bytes: core (r//8, k//8) at element
    ((r//8) * (K//8) + k//8) * 64, row r%8 of it at (r%8) * 8. The
    no-swizzle K-major layout of a wgmma operand whose descriptor has
    leading byte offset 128 (cores adjacent in K) and stride byte offset
    K/8 * 128 (cores adjacent in R)."""
    *lead, r, k = t.shape
    return (t.reshape(*lead, r // 8, 8, k // 8, 8).transpose(-3, -2)
            .reshape(*lead, r * k))


def _from_cores(t: torch.Tensor, r: int, k: int) -> torch.Tensor:
    """Inverse of `_to_cores`: [..., R * K] -> [..., R, K]."""
    lead = t.shape[:-1]
    return t.reshape(*lead, r // 8, k // 8, 8, 8).transpose(-3, -2).reshape(*lead, r, k)


def pack_segment(w: SegmentWeights) -> torch.Tensor:
    """The segment kernel's weight stream: bf16 [n_blocks, 2 C/Cb + 9 inner,
    Cb * Cb]. Per block, in the order the kernel consumes them: the reduce
    split along K into C/Cb chunks, one chunk per 3x3 tap, the expand split
    along N into C/Cb chunks (the reduce's K and the expand's N both in
    `reduce_k_order`). A chunk is B^T [n][k] (Cb x Cb) in 8x8 core matrices
    of 128 contiguous bytes, core (n//8, k//8) at element
    ((n//8) * (Cb//8) + k//8) * 64, row n%8 of it at (n%8) * 8: the
    no-swizzle K-major layout of a wgmma B descriptor, so one bulk copy
    lands it ready to use."""
    n_blocks, layers = w.aff.shape[:2]
    C, cb = w.wr.shape[1:]
    if cb % 32 or C % cb:
        raise ValueError(f"pack_segment needs Cb % 32 == 0 and C % Cb == 0, got {(C, cb)}")
    split, inner = C // cb, layers - 2
    order = reduce_k_order(C).to(w.wr.device)
    wr, we = w.wr[:, order, :], w.we[:, :, order]  # [nb, K, Cb], [nb, Cb, N]
    mats = [wr[:, kc * cb:(kc + 1) * cb, :] for kc in range(split)]
    mats += [w.w9[:, j, o * cb:(o + 1) * cb, :] for j in range(inner) for o in range(9)]
    mats += [we[:, :, nc * cb:(nc + 1) * cb] for nc in range(split)]
    bt = torch.stack(mats, dim=1).transpose(2, 3)  # [nb, chunks, n, k]
    return _to_cores(bt).contiguous()


def unpack_segment(packed: torch.Tensor, channels: int, inner: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of `pack_segment`: -> (wr, w9, we) as in SegmentWeights."""
    n_blocks, n_chunks, cc = packed.shape
    cb = int(round(cc ** 0.5))
    split = channels // cb
    if cb * cb != cc or n_chunks != _chunks_per_block(channels, cb, inner):
        raise ValueError(f"packed {tuple(packed.shape)} is not a segment of "
                         f"C={channels}, inner={inner}")
    b = _from_cores(packed, cb, cb).transpose(2, 3)  # [nb, chunks, k, n]
    order = reduce_k_order(channels).to(packed.device)
    wr = torch.empty((n_blocks, channels, cb), dtype=packed.dtype, device=packed.device)
    wr[:, order, :] = torch.cat([b[:, kc] for kc in range(split)], dim=1)
    w9 = b[:, split:split + 9 * inner].reshape(n_blocks, inner, 9 * cb, cb)
    we = torch.empty((n_blocks, cb, channels), dtype=packed.dtype, device=packed.device)
    we[:, :, order] = torch.cat([b[:, split + 9 * inner + nc] for nc in range(split)], dim=2)
    return wr, w9.contiguous(), we


def broadcast_packed_size(channels: int) -> int:
    return 2 * channels * channels + MIX_PAD * MIX_PAD


def pack_broadcast(w: BroadcastWeights) -> torch.Tensor:
    """The broadcast kernel's weights, bf16 [2 C^2 + 384^2], in the layouts
    its wgmma descriptors read (`_to_cores`), packed once on the host:
    * Wf as B^T [n][k] (C x C), K (input channels) in `reduce_k_order`, so a
      lane's 16-byte load of x is its conv_first A fragments;
    * Wl as B^T [n][k], N (output channels) in `reduce_k_order`, so a lane's
      conv_last accumulators are 8 contiguous channels of the residual;
    * WdT [384, 384] as the mix's A stream: for each M tile t of 64
      destination rows q and each chunk c of MIX_CHUNK_COLS source columns
      p, the chunk WdT[64 t:, 32 c:] (64 x 32) at (t * 12 + c) * 2048."""
    C = w.wf.shape[0]
    order = reduce_k_order(C).to(w.wf.device)
    ct = MIX_PAD // MIX_CHUNK_COLS
    wdt = w.wdt.reshape(MIX_PAD // 64, 64, ct, MIX_CHUNK_COLS).transpose(1, 2)
    return torch.cat([_to_cores(w.wf[order].t()), _to_cores(w.wl[:, order].t()),
                      _to_cores(wdt).flatten()]).contiguous()


def unpack_broadcast(packed: torch.Tensor, channels: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of `pack_broadcast`: -> (wf, wdt, wl) as in BroadcastWeights."""
    C = channels
    if tuple(packed.shape) != (broadcast_packed_size(C),):
        raise ValueError(f"packed {tuple(packed.shape)} is not a broadcast block of C={C}")
    order = reduce_k_order(C).to(packed.device)
    wf = torch.empty((C, C), dtype=packed.dtype, device=packed.device)
    wf[order] = _from_cores(packed[:C * C], C, C).t()
    wl = torch.empty_like(wf)
    wl[:, order] = _from_cores(packed[C * C:2 * C * C], C, C).t()
    ct = MIX_PAD // MIX_CHUNK_COLS
    wdt = (_from_cores(packed[2 * C * C:].reshape(MIX_PAD // 64, ct, -1), 64, MIX_CHUNK_COLS)
           .transpose(1, 2).reshape(MIX_PAD, MIX_PAD))
    return wf, wdt.contiguous(), wl


def _check_x(x: torch.Tensor, channels: int) -> None:
    if x.dim() != 3 or x.shape[1] != NUM_LOCS or x.shape[2] != channels:
        raise ValueError(f"x must be [N, {NUM_LOCS}, {channels}], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no trunk kernel for device {x.device}")


def _check_weights(x: torch.Tensor, weights: NamedTuple) -> None:
    for name, t in zip(type(weights)._fields, weights):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"weight {name} on {t.device}, x on {x.device}")
        want = torch.float32 if name in ("aff", "f_aff", "l_aff", "bd") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"weight {name} must be {want}, got {t.dtype}")
        if x.device.type == "cuda" and not (t.is_contiguous() and t.data_ptr() % 32 == 0):
            raise ValueError(f"weight {name} must be contiguous and 32-byte aligned")


def _check_launchable(x: torch.Tensor) -> None:
    if not x.is_contiguous() or x.data_ptr() % 32 != 0:
        raise ValueError("x must be contiguous and 32-byte aligned")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _segment_kernel():
    fn = load_library(SEGMENT_SOURCE).p3_trunk_segment
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _broadcast_kernel():
    fn = load_library(SOURCE).p3_trunk_broadcast
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trunk_segment(x: torch.Tensor, w: SegmentWeights) -> torch.Tensor:
    """`n_blocks` consecutive bottleneck blocks: x [N, 361, C] bf16 -> a new
    tensor of the same shape."""
    n_blocks, layers = w.aff.shape[:2]
    C, cb = w.wr.shape[1:]
    inner = layers - 2
    shapes = {"aff": (n_blocks, layers, 2, C), "wr": (n_blocks, C, cb),
              "w9": (n_blocks, inner, 9 * cb, cb), "we": (n_blocks, cb, C)}
    if w.packed is not None:
        shapes["packed"] = (n_blocks, _chunks_per_block(C, cb, inner), cb * cb)
    for name, want in shapes.items():
        if tuple(getattr(w, name).shape) != want:
            raise ValueError(f"weight {name} is {tuple(getattr(w, name).shape)}, want {want}")
    if n_blocks < 1:
        raise ValueError("a segment has at least one block")
    _check_x(x, C)
    _check_weights(x, w)
    if x.device.type == "cpu":
        return trunk_segment_reference(x, w)
    if (C, cb) not in SEGMENT_WIDTHS or inner > MAX_INNER:
        raise ValueError(f"the segment kernel takes (channels, bottleneck) in "
                         f"{SEGMENT_WIDTHS} and at most {MAX_INNER} inner layers, "
                         f"not {(C, cb)} with {inner}")
    if w.packed is None:
        raise ValueError("the segment kernel reads the packed weights: "
                         "SegmentWeights(..., packed=pack_segment(w))")
    _check_launchable(x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = _segment_kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), w.aff.data_ptr(), w.packed.data_ptr(),
                x.shape[0], n_blocks, inner, C, cb, _stream(x))
    if rc != 0:
        raise RuntimeError(f"trunk segment kernel launch failed: cudaError {rc}")
    trunk_segment.launches += 1
    return out


def trunk_broadcast(x: torch.Tensor, w: BroadcastWeights) -> torch.Tensor:
    """One broadcast block: x [N, 361, C] bf16 -> a new tensor of the same
    shape."""
    C = w.wf.shape[0]
    shapes = {"f_aff": (2, C), "wf": (C, C), "wdt": (MIX_PAD, MIX_PAD),
              "bd": (NUM_LOCS,), "l_aff": (2, C), "wl": (C, C)}
    if w.packed is not None:
        shapes["packed"] = (broadcast_packed_size(C),)
    for name, want in shapes.items():
        if tuple(getattr(w, name).shape) != want:
            raise ValueError(f"weight {name} is {tuple(getattr(w, name).shape)}, want {want}")
    _check_x(x, C)
    _check_weights(x, w)
    if x.device.type == "cpu":
        return trunk_broadcast_reference(x, w)
    if C not in BROADCAST_WIDTHS:
        raise ValueError(f"the broadcast kernel takes channels in "
                         f"{BROADCAST_WIDTHS}, not {C}")
    if w.packed is None:
        raise ValueError("the broadcast kernel reads the packed weights: "
                         "BroadcastWeights(..., packed=pack_broadcast(w))")
    _check_launchable(x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = _broadcast_kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), w.f_aff.data_ptr(), w.packed.data_ptr(),
                w.bd.data_ptr(), w.l_aff.data_ptr(), x.shape[0], C, _stream(x))
    if rc != 0:
        raise RuntimeError(f"trunk broadcast kernel launch failed: cudaError {rc}")
    trunk_broadcast.launches += 1
    return out


trunk_segment.launches = 0
trunk_broadcast.launches = 0
