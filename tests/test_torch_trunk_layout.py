"""The layout the segment kernel (csrc/trunk_segment.cu) reads, held on the
CPU: the packed weight stream (`pack_segment`) unpacks to the weights it
came from and puts each element where the wgmma B descriptor reads it, the
reduce's K order matches what each lane loads, and the M tiling of the
zero-haloed grid covers the board exactly once with every tap in bounds.
All checks are exact."""
import numpy as np
import pytest
import torch

from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn
from p3achygo_tpu_torch.ops import trunk as ops

torch.set_num_threads(2)


def _weights(C, cb, inner, n_blocks, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    aff = torch.stack([0.7 + 0.6 * torch.from_numpy(rng.random((n_blocks, 2 + inner, C),
                                                               dtype=np.float32)),
                       0.1 * t(n_blocks, 2 + inner, C)], dim=2)
    return ops.SegmentWeights(aff.contiguous(),
                              (t(n_blocks, C, cb) / C ** 0.5).bfloat16(),
                              (t(n_blocks, inner, 9 * cb, cb) / (3 * cb ** 0.5)).bfloat16(),
                              (t(n_blocks, cb, C) / cb ** 0.5).bfloat16())


def _core_offset(n, k, cb):
    """Element offset of B^T[n][k] in a packed chunk: 8x8 core matrices of
    128 bytes, core (n//8, k//8) at ((n//8) * (cb//8) + k//8) * 64."""
    return ((n // 8) * (cb // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8


WIDTH_CASES = [(C, cb, inner, nb) for C, cb in ops.SEGMENT_WIDTHS
               for inner, nb in ((0, 1), (1, 2), (2, 1), (3, 3))]


@pytest.mark.parametrize("C,cb,inner,nb", WIDTH_CASES)
def test_packed_weights_unpack_to_the_originals(C, cb, inner, nb):
    w = _weights(C, cb, inner, nb, seed=C + inner)
    packed = ops.pack_segment(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (nb, 2 * (C // cb) + 9 * inner, cb * cb)
    wr, w9, we = ops.unpack_segment(packed, C, inner)
    for got, want in ((wr, w.wr), (w9, w.w9), (we, w.we)):
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 361, C))
                         .astype(np.float32)).bfloat16()
    unpacked = w._replace(wr=wr, w9=w9, we=we)
    assert torch.equal(ops.trunk_segment_reference(x, unpacked),
                       ops.trunk_segment_reference(x, w))


@pytest.mark.parametrize("C,cb", ops.SEGMENT_WIDTHS)
def test_packed_chunks_sit_where_the_descriptor_reads(C, cb):
    """Chunk order per block: the reduce by K, one chunk per 3x3 tap, the
    expand by N (the reduce's K and the expand's N in reduce_k_order); each
    chunk B^T [n][k] in core matrices."""
    inner, split = 2, C // cb
    w = _weights(C, cb, inner, 2, seed=3)
    packed = ops.pack_segment(w).float()
    order = ops.reduce_k_order(C)
    rng = np.random.default_rng(4)
    for blk in range(2):
        for n, k in rng.integers(0, cb, (40, 2)):
            off = _core_offset(n, k, cb)
            for kc in range(split):
                assert packed[blk, kc, off] == w.wr[blk, order[kc * cb + k], n].float()
            for j in range(inner):
                for o in range(9):
                    assert packed[blk, split + 9 * j + o, off] == \
                        w.w9[blk, j, o * cb + k, n].float()
            for nc in range(split):
                assert packed[blk, split + 9 * inner + nc, off] == \
                    w.we[blk, k, order[nc * cb + n]].float()


@pytest.mark.parametrize("C", [64, 128])
def test_reduce_k_order_matches_the_lanes_loads(C):
    """Lane t4 of a quad loads channels 32q + 8 t4 .. +7 of a row as four
    bf16 pairs: logical k (2 t4, 2 t4 + 1) and (2 t4 + 8, 2 t4 + 9) of
    k-step 2q, then the same of k-step 2q + 1 (the mma A fragment). In the
    expand the same lane holds accumulator columns 8j + 2 t4 + e for
    j = 4q .. 4q + 3: the same channels, in the same order."""
    order = ops.reduce_k_order(C).tolist()
    assert sorted(order) == list(range(C))
    for q in range(C // 32):
        for t4 in range(4):
            loaded = list(range(32 * q + 8 * t4, 32 * q + 8 * t4 + 8))
            frag = [16 * (2 * q + s) + 2 * t4 + d + e
                    for s in (0, 1) for d in (0, 8) for e in (0, 1)]
            assert [order[k] for k in frag] == loaded
            acc_cols = [8 * j + 2 * t4 + e for j in range(4 * q, 4 * q + 4) for e in (0, 1)]
            assert [order[n] for n in acc_cols] == loaded


def test_interior_tiles_cover_every_position_once():
    tiles = ops.segment_tile_positions()
    assert tiles.shape == (ops.SEGMENT_TILES, ops.TILE_ROWS) == (6, 64)
    pos = tiles[tiles >= 0]
    assert sorted(pos.tolist()) == list(range(361))
    assert int((tiles < 0).sum()) == 6 * 64 - 361 == 23
    # the pad rows are the tail of the last tile
    assert bool((tiles.flatten()[361:] < 0).all())


def test_tap_addresses_stay_in_the_haloed_buffer():
    """Row halo_row(p) + TAP_SHIFTS[o] of every tile row (pad rows read
    position 360) is inside the 21x21 grid, is the neighbour (i+di, j+dj)
    there, and is a halo row exactly when that neighbour is off the board."""
    tiles = ops.segment_tile_positions().flatten()
    p = torch.where(tiles >= 0, tiles, 360)
    base = ops.halo_row(p)
    assert ops.TAP_SHIFTS == tuple((di * 21 + dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))
    i, j = p // 19, p % 19
    for o, shift in enumerate(ops.TAP_SHIFTS):
        di, dj = o // 3 - 1, o % 3 - 1
        r = base + shift
        assert int(r.min()) >= 0 and int(r.max()) < ops.HALO_ROWS
        assert torch.equal(r, (i + di + 1) * 21 + (j + dj + 1))
        hi, hj = r // 21, r % 21
        halo = (hi == 0) | (hi == 20) | (hj == 0) | (hj == 20)
        off = (i + di < 0) | (i + di > 18) | (j + dj < 0) | (j + dj > 18)
        assert torch.equal(halo, off)
    assert sorted(set(base[tiles >= 0].tolist())) == sorted(
        (a + 1) * 21 + b + 1 for a in range(19) for b in range(19))


@pytest.mark.parametrize("name,packed", [("b8c64", True), ("tiny", False)])
def test_trunk_weights_carry_the_packed_stream(name, packed):
    """build_trunk_fn packs each segment once for the widths the kernel
    takes; on the CPU the wrapper still runs the plain version."""
    cfg = get_config(name)
    model = build_model(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    fn = build_trunk_fn(cfg, model)
    segs = [s.weights for s in fn.segments if s.kernel is ops.trunk_segment]
    assert segs
    for w in segs:
        assert (w.packed is not None) == packed
        if packed:
            assert torch.equal(w.packed, ops.pack_segment(w))
            x = torch.zeros((1, 361, cfg.channels), dtype=torch.bfloat16)
            assert torch.equal(ops.trunk_segment(x, w), ops.trunk_segment_reference(x, w))


def test_wrapper_rejects_a_packed_stream_of_the_wrong_shape():
    w = _weights(64, 32, 2, 1, seed=5)
    w = w._replace(packed=ops.pack_segment(w)[:, :-1])
    with pytest.raises(ValueError):
        ops.trunk_segment(torch.zeros((1, 361, 64), dtype=torch.bfloat16), w)
