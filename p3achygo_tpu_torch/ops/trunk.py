"""Fused-trunk kernels: the hand-written CUDA kernels and their plain
PyTorch versions (counterparts of the Pallas kernels of p3achygo_tpu's
nn/trunk_kernel.py `_make_kernel` and nn/trunk_kernel2.py
`_make_segment_kernel`).

Two calls make a trunk of bottleneck and broadcast blocks, on activations
x [N, 361, C] bf16 (channels last, one row per board position):

* `trunk_segment` runs a run of consecutive bottleneck blocks in one
  launch of `csrc/trunk_segment.cu` `p3_trunk_segment` (wgmma, weights
  staged by bulk-async copies, persistent blocks);
* `trunk_broadcast` runs one broadcast block through
  `csrc/trunk_broadcast.cu` `p3_trunk_broadcast`: one kernel at C <= 128
  (wgmma for all three products, the position mix streamed by bulk-async
  copies, persistent blocks), three at C = 256 and 384 (conv_first, the
  mix, conv_last, each a warp-specialised wgmma GEMM with its part of the
  elementwise chain fused).

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

Widths: the segment kernel takes (C, Cb) in SEGMENT_WIDTHS and the
broadcast kernel C in BROADCAST_WIDTHS. `tiny`'s (16, 8) and 16
(SEGMENT_SMALL, BROADCAST_SMALL) have kernels of their own: the segment a
board a block of SMALL_WARPS warps, several blocks an SM, x in registers as
mma.sync fragments; the broadcast block SMALL_GROUP boards a mix. At C = 64
and 128 a block holds a whole board; at C = 256 and 384 a segment splits a
board's positions over a thread-block cluster (SEGMENT_CLUSTER) and a
broadcast block runs as three kernels (BROADCAST_WIDE) with m in device
memory between them. `with_packed_segment` / `with_packed_broadcast` pack
once. A width no kernel takes raises on the card; nothing falls back to
the plain version.

The segment kernel reads its weights as `pack_segment` lays them out: a
stream of Cb x Cb chunks in the shared-memory layout of the wgmma B operand,
packed once on the host, or at SEGMENT_SMALL each lane's mma B fragment
words (`small_k_order`). `unpack_segment` inverts it, and
`segment_tile_positions` / `TAP_SHIFTS` spell out the kernel's M tiling of
the zero-haloed 21x21 grid. The broadcast kernels read `pack_broadcast`'s
layout (Wf and Wl as B operands or, at BROADCAST_SMALL, B fragment words;
WdT as A-operand chunks or tiles), inverted by `unpack_broadcast`. The CPU
tests hold all of them.
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
SEGMENT_WIDTHS = ((16, 8), (64, 32), (128, 64), (256, 128), (384, 192))
BROADCAST_WIDTHS = (16, 64, 128, 256, 384)
MAX_INNER = 3
# tiny's widths, whose kernels take their weights as mma.sync B fragments
# (`_mma_b_words`): the segment a board a block of SMALL_WARPS warps, warp w
# owning the SMALL_TILE_ROWS-row M tiles w, w + SMALL_WARPS, ...; the
# broadcast block SMALL_GROUP boards a mix.
SEGMENT_SMALL = (16, 8)
BROADCAST_SMALL = 16
SMALL_WARPS = 4
SMALL_TILE_ROWS = 16
SMALL_GROUP = 8
# The segment widths whose kernel splits a board over a thread-block
# cluster, and the cluster's blocks (each TILE_ROWS * 6 / blocks positions).
SEGMENT_CLUSTER = {(256, 128): 2, (384, 192): 3}
# The broadcast widths that run as three kernels (conv_first, the mix,
# conv_last). conv_first's B items are BROADCAST_ITEM_WF = (N, K) = 64
# output columns by 64 K rows of Wf (8 KB), conv_last's BROADCAST_ITEM_WL =
# 128 by 64 of Wl (16 KB), each in the order (n tile, K chunk); the mix's
# are m's, which conv_first writes as scratch [N, 6, C/8, 8, 64]: per board
# and 64-position chunk, B^T [C channels][64 positions] in 8x8 core
# matrices, read 128 channels (16 KB) at a time.
BROADCAST_WIDE = (256, 384)
BROADCAST_ITEM_WF = (64, 64)
BROADCAST_ITEM_WL = (128, 64)
# The segment kernel streams a chunk as items of this many K rows (input
# channels) where it is not the whole chunk: at (384, 192) every consumer
# group reads every item, a 192 x 64 third of the chunk.
SEGMENT_ITEM_K = {(384, 192): 64}

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


def cluster_window(rank: int, tiles_per_block: int) -> Tuple[int, int]:
    """(first grid row, grid rows) of the haloed-grid window that block
    `rank` of a segment cluster keeps, when each block owns
    `tiles_per_block` consecutive M tiles: the board rows of its positions
    and one more on each side, 21 grid rows each (csrc/trunk_segment.cu
    `window_first`, `window_board_rows`)."""
    first = TILE_ROWS * tiles_per_block * rank
    last = min(TILE_ROWS * tiles_per_block * (rank + 1), NUM_LOCS) - 1
    return first // 19 * HALO_W, (last // 19 + 2 - first // 19 + 1) * HALO_W


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


def small_k_order() -> torch.Tensor:
    """int64 [16]: the channel at each logical K index of the small kernels'
    16-channel products (the reduce, conv_first) and at each logical N index
    (output column) of their 16-channel outputs (the expand, conv_last).
    Lane t of a quad loads channels 4t .. 4t + 3 of a row, 8 bytes, which
    are logical k (2t, 2t + 1) and (2t + 8, 2t + 9) of the mma.m16n8k16 A
    fragment; an output's two 8-column n-tiles put columns 2t, 2t + 1 of
    n-tile j in the same lane, channels 4t + 2j, 4t + 2j + 1."""
    l = torch.arange(16)
    return 4 * ((l % 8) // 2) + 2 * (l // 8) + l % 2


def _mma_b_fragments(k: int, n: int, kperm: torch.Tensor, nperm: torch.Tensor):
    """(rows [K/8, 32, 2], columns [N/8, 32]) of the mma.sync B fragments of
    a [K, N] matrix whose logical K index i is row kperm[i] and logical N
    index j column nperm[j]: for n-tile nt, k-group kg (8 K rows: b0 of a
    m16n8k16 k-step is its group 2s, b1 group 2s + 1; a m16n8k8 step one
    group) and lane l (g = l // 4, t = l % 4), the 32-bit word holds logical
    (k 8 kg + 2t, n 8 nt + g) in its low half and (k 8 kg + 2t + 1, the same
    n) in its high half."""
    lane = torch.arange(32, device=kperm.device)
    e = torch.arange(2, device=kperm.device)
    rows = kperm[8 * torch.arange(k // 8, device=kperm.device)[:, None, None]
                 + 2 * (lane % 4)[None, :, None] + e[None, None, :]]
    cols = nperm[8 * torch.arange(n // 8, device=nperm.device)[:, None]
                 + (lane // 4)[None, :]]
    return rows, cols


def _mma_b_words(w: torch.Tensor, kperm: torch.Tensor, nperm: torch.Tensor) -> torch.Tensor:
    """w [..., K, N] -> its B fragment words as bf16 [..., N/8, K/8, 32, 2]
    (n-tile, k-group, lane, half; `_mma_b_fragments`)."""
    rows, cols = _mma_b_fragments(*w.shape[-2:], kperm.to(w.device), nperm.to(w.device))
    return w[..., rows[None], cols[:, None, :, None]]


def _from_mma_b_words(words: torch.Tensor, k: int, n: int, kperm: torch.Tensor,
                      nperm: torch.Tensor) -> torch.Tensor:
    """Inverse of `_mma_b_words`: [..., N/8, K/8, 32, 2] -> [..., K, N]."""
    rows, cols = _mma_b_fragments(k, n, kperm.to(words.device), nperm.to(words.device))
    lead = words.shape[:-4]
    w = words.new_empty((*lead, k, n))
    w[..., rows[None], cols[:, None, :, None]] = words
    return w


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
    ((n//8) * (Kc//8) + k//8) * 64, row n%8 of it at (n%8) * 8: the
    no-swizzle K-major layout of a wgmma B descriptor, so one bulk copy
    lands it ready to use. Kc is Cb, or SEGMENT_ITEM_K where the kernel
    streams a chunk as Cb / Kc items: then item i (K rows i Kc .. i Kc +
    Kc - 1) is laid out so, at element i * Cb * Kc of the chunk.

    At SEGMENT_SMALL a "chunk" is one 64-element group of mma B fragment
    words, a 32-bit word a lane (`_mma_b_words`), in the same order: the
    reduce's two k-groups (K in `small_k_order`), nine a 3x3 layer (k-group
    o = tap o), the expand's two n-tiles (N in `small_k_order`)."""
    n_blocks, layers = w.aff.shape[:2]
    C, cb = w.wr.shape[1:]
    split, inner = C // cb, layers - 2
    if (C, cb) == SEGMENT_SMALL:
        small, nat = small_k_order(), torch.arange(72)
        parts = ((_mma_b_words(w.wr, small, nat[:cb]), 2),
                 (_mma_b_words(w.w9, nat, nat[:cb]), 9 * inner),
                 (_mma_b_words(w.we, nat[:cb], small), 2))
        return torch.cat([t.reshape(n_blocks, n, 64) for t, n in parts], dim=1).contiguous()
    if cb % 32 or C % cb:
        raise ValueError(f"pack_segment needs Cb % 32 == 0 and C % Cb == 0, or "
                         f"{SEGMENT_SMALL}, got {(C, cb)}")
    order = reduce_k_order(C).to(w.wr.device)
    wr, we = w.wr[:, order, :], w.we[:, :, order]  # [nb, K, Cb], [nb, Cb, N]
    mats = [wr[:, kc * cb:(kc + 1) * cb, :] for kc in range(split)]
    mats += [w.w9[:, j, o * cb:(o + 1) * cb, :] for j in range(inner) for o in range(9)]
    mats += [we[:, :, nc * cb:(nc + 1) * cb] for nc in range(split)]
    bt = torch.stack(mats, dim=1).transpose(2, 3)  # [nb, chunks, n, k]
    ik = SEGMENT_ITEM_K.get((C, cb), cb)
    bt = bt.reshape(*bt.shape[:3], cb // ik, ik).transpose(2, 3)  # [.., item, n, k]
    return _to_cores(bt).reshape(n_blocks, -1, cb * cb).contiguous()


def unpack_segment(packed: torch.Tensor, channels: int, inner: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of `pack_segment`: -> (wr, w9, we) as in SegmentWeights."""
    n_blocks, n_chunks, cc = packed.shape
    cb = int(round(cc ** 0.5))
    split = channels // cb
    if cb * cb != cc or n_chunks != _chunks_per_block(channels, cb, inner):
        raise ValueError(f"packed {tuple(packed.shape)} is not a segment of "
                         f"C={channels}, inner={inner}")
    if (channels, cb) == SEGMENT_SMALL:
        small, nat = small_k_order(), torch.arange(72)
        wr = _from_mma_b_words(packed[:, :2].reshape(n_blocks, 1, 2, 32, 2), channels, cb,
                               small, nat[:cb])
        w9 = _from_mma_b_words(packed[:, 2:2 + 9 * inner].reshape(n_blocks, inner, 1, 9, 32, 2),
                               9 * cb, cb, nat, nat[:cb])
        we = _from_mma_b_words(packed[:, 2 + 9 * inner:].reshape(n_blocks, 2, 1, 32, 2), cb,
                               channels, nat[:cb], small)
        return wr, w9, we
    ik = SEGMENT_ITEM_K.get((channels, cb), cb)
    b = _from_cores(packed.reshape(n_blocks, n_chunks, cb // ik, cb * ik), cb, ik)
    b = b.transpose(2, 3).reshape(n_blocks, n_chunks, cb, cb).transpose(2, 3)  # [.., k, n]
    order = reduce_k_order(channels).to(packed.device)
    wr = torch.empty((n_blocks, channels, cb), dtype=packed.dtype, device=packed.device)
    wr[:, order, :] = torch.cat([b[:, kc] for kc in range(split)], dim=1)
    w9 = b[:, split:split + 9 * inner].reshape(n_blocks, inner, 9 * cb, cb)
    we = torch.empty((n_blocks, cb, channels), dtype=packed.dtype, device=packed.device)
    we[:, :, order] = torch.cat([b[:, split + 9 * inner + nc] for nc in range(split)], dim=2)
    return wr, w9.contiguous(), we


def segment_kernel_width(channels: int, bottleneck: int) -> Optional[Tuple[int, int]]:
    """(channels, bottleneck) if a segment kernel takes that width, else
    None."""
    return (channels, bottleneck) if (channels, bottleneck) in SEGMENT_WIDTHS else None


def broadcast_kernel_width(channels: int) -> Optional[int]:
    """`channels` if a broadcast kernel takes that width, else None."""
    return channels if channels in BROADCAST_WIDTHS else None


def with_packed_segment(w: SegmentWeights) -> SegmentWeights:
    """w with what the segment kernel reads, `packed`, packed once; w as it
    is where no kernel takes its width."""
    C, cb = w.wr.shape[1:]
    if segment_kernel_width(C, cb) is None or w.aff.shape[1] - 2 > MAX_INNER:
        return w
    return w._replace(packed=pack_segment(w))


def with_packed_broadcast(w: BroadcastWeights) -> BroadcastWeights:
    """w with what the broadcast kernel reads, `packed`, packed once; w as
    it is where no kernel takes its width."""
    if broadcast_kernel_width(w.wf.shape[0]) is None:
        return w
    return w._replace(packed=pack_broadcast(w))


def broadcast_packed_size(channels: int) -> int:
    return 2 * channels * channels + MIX_PAD * MIX_PAD


def _wide_items(bt: torch.Tensor, item: Tuple[int, int]) -> torch.Tensor:
    """B^T [C n][C k] -> the wide kernels' items: for each n tile and K
    chunk of `item` = (n, k) (n tile major), the piece in core matrices
    (`_to_cores`), flattened."""
    C = bt.shape[0]
    n_item, k_item = item
    items = bt.reshape(C // n_item, n_item, C // k_item, k_item).transpose(1, 2)
    return _to_cores(items).flatten()


def _from_wide_items(flat: torch.Tensor, C: int, item: Tuple[int, int]) -> torch.Tensor:
    """Inverse of `_wide_items`."""
    n_item, k_item = item
    items = _from_cores(flat.reshape(C // n_item, C // k_item, n_item * k_item), n_item,
                        k_item)
    return items.transpose(1, 2).reshape(C, C)


def pack_broadcast(w: BroadcastWeights) -> torch.Tensor:
    """The broadcast kernels' weights, bf16 [2 C^2 + 384^2], in the layouts
    their wgmma descriptors read (`_to_cores`), packed once on the host.
    At C = 64 and 128 (one kernel):
    * Wf as B^T [n][k] (C x C), K (input channels) in `reduce_k_order`, so a
      lane's 16-byte load of x is its conv_first A fragments;
    * Wl as B^T [n][k], N (output channels) in `reduce_k_order`, so a lane's
      conv_last accumulators are 8 contiguous channels of the residual;
    * WdT [384, 384] as the mix's A stream: for each M tile t of 64
      destination rows q and each chunk c of MIX_CHUNK_COLS source columns
      p, the chunk WdT[64 t:, 32 c:] (64 x 32) at (t * 12 + c) * 2048.
    At BROADCAST_WIDE (three kernels):
    * Wf and Wl as B^T [n][k] with K and N both in `reduce_k_order` (m's
      and the output's channels 8 contiguous a lane), as
      `BROADCAST_ITEM_WF` and `BROADCAST_ITEM_WL` items (`_wide_items`);
    * WdT as six 64-row tiles, tile t = WdT[64 t:64 t + 64, :] (A [q][p],
      64 x 384) at t * 24576.
    At BROADCAST_SMALL: Wf's and Wl's mma B fragment words
    (`_mma_b_words`, [n-tile][k-group][lane][half]), Wf's K and Wl's N in
    `small_k_order`, then WdT's chunk stream as at C = 64 and 128."""
    C = w.wf.shape[0]
    ct = MIX_PAD // MIX_CHUNK_COLS
    wdt = w.wdt.reshape(MIX_PAD // 64, 64, ct, MIX_CHUNK_COLS).transpose(1, 2)
    if C == BROADCAST_SMALL:
        small, nat = small_k_order(), torch.arange(C)
        return torch.cat([_mma_b_words(w.wf, small, nat).flatten(),
                          _mma_b_words(w.wl, nat, small).flatten(),
                          _to_cores(wdt).flatten()]).contiguous()
    order = reduce_k_order(C).to(w.wf.device)
    if C in BROADCAST_WIDE:
        wf, wl = (t[order][:, order].t() for t in (w.wf, w.wl))
        return torch.cat([_wide_items(wf, BROADCAST_ITEM_WF), _wide_items(wl, BROADCAST_ITEM_WL),
                          _to_cores(w.wdt.reshape(MIX_PAD // 64, 64, MIX_PAD)).flatten()
                          ]).contiguous()
    return torch.cat([_to_cores(w.wf[order].t()), _to_cores(w.wl[:, order].t()),
                      _to_cores(wdt).flatten()]).contiguous()


def unpack_broadcast(packed: torch.Tensor, channels: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of `pack_broadcast`: -> (wf, wdt, wl) as in BroadcastWeights."""
    C = channels
    if tuple(packed.shape) != (broadcast_packed_size(C),):
        raise ValueError(f"packed {tuple(packed.shape)} is not a broadcast block of C={C}")
    ct = MIX_PAD // MIX_CHUNK_COLS
    if C == BROADCAST_SMALL:
        small, nat = small_k_order(), torch.arange(C)
        words = packed[:2 * C * C].reshape(2, 2, 2, 32, 2)
        wdt = (_from_cores(packed[2 * C * C:].reshape(MIX_PAD // 64, ct, -1), 64, MIX_CHUNK_COLS)
               .transpose(1, 2).reshape(MIX_PAD, MIX_PAD))
        return (_from_mma_b_words(words[0], C, C, small, nat), wdt.contiguous(),
                _from_mma_b_words(words[1], C, C, nat, small))
    order = reduce_k_order(C).to(packed.device)
    wf = torch.empty((C, C), dtype=packed.dtype, device=packed.device)
    wl = torch.empty_like(wf)
    if C in BROADCAST_WIDE:
        wf[order[:, None], order[None, :]] = _from_wide_items(packed[:C * C], C,
                                                              BROADCAST_ITEM_WF).t()
        wl[order[:, None], order[None, :]] = _from_wide_items(packed[C * C:2 * C * C], C,
                                                              BROADCAST_ITEM_WL).t()
        wdt = _from_cores(packed[2 * C * C:].reshape(MIX_PAD // 64, -1), 64, MIX_PAD)
        return wf, wdt.reshape(MIX_PAD, MIX_PAD).contiguous(), wl
    wf[order] = _from_cores(packed[:C * C], C, C).t()
    wl[:, order] = _from_cores(packed[C * C:2 * C * C], C, C).t()
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
        want = (torch.float32 if name in ("aff", "f_aff", "l_aff", "bd")
                else torch.bfloat16)
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
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    if segment_kernel_width(C, cb) is None or inner > MAX_INNER:
        raise ValueError(f"the segment kernel takes (channels, bottleneck) in "
                         f"{SEGMENT_WIDTHS} and at most {MAX_INNER} inner layers, not "
                         f"{(C, cb)} with {inner}")
    if w.packed is None:
        raise ValueError("the segment kernel reads the packed weights: "
                         "with_packed_segment(w)")
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
    shape. One call launches one kernel, or three at BROADCAST_WIDE; it
    adds one to `.launches` either way."""
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
    if broadcast_kernel_width(C) is None:
        raise ValueError(f"the broadcast kernel takes channels in {BROADCAST_WIDTHS}, "
                         f"not {C}")
    if w.packed is None:
        raise ValueError("the broadcast kernel reads the packed weights: "
                         "with_packed_broadcast(w)")
    _check_launchable(x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = _broadcast_kernel()
    # The three kernels at BROADCAST_WIDE pass m through device memory.
    m = (torch.empty((x.shape[0] * MIX_PAD * C,), dtype=torch.bfloat16, device=x.device)
         if C in BROADCAST_WIDE else None)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), w.f_aff.data_ptr(), w.packed.data_ptr(),
                w.bd.data_ptr(), w.l_aff.data_ptr(), None if m is None else m.data_ptr(),
                x.shape[0], C, _stream(x))
    if rc != 0:
        raise RuntimeError(f"trunk broadcast kernel launch failed: cudaError {rc}")
    trunk_broadcast.launches += 1
    return out


trunk_segment.launches = 0
trunk_broadcast.launches = 0
