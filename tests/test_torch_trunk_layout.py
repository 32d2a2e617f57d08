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


# ---- the broadcast kernel (csrc/trunk_broadcast.cu) ----------------------

def _bc_weights(C, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
    wdt = torch.zeros((ops.MIX_PAD, ops.MIX_PAD))
    wdt[:361, :361] = t(361, 361) / 19.0
    return ops.BroadcastWeights(
        torch.stack([0.7 + 0.6 * torch.from_numpy(rng.random(C, dtype=np.float32)),
                     0.1 * t(C)]).contiguous(),
        (t(C, C) / C ** 0.5).bfloat16(), wdt.bfloat16(), 0.1 * t(361),
        torch.stack([0.7 + 0.6 * torch.from_numpy(rng.random(C, dtype=np.float32)),
                     0.1 * t(C)]).contiguous(),
        (t(C, C) / C ** 0.5).bfloat16())


def _desc_read(img, start, lbo, sbo, rows):
    """The [rows x 16] K-major operand a no-swizzle wgmma descriptor
    (start, leading byte offset, stride byte offset; all in bytes) reads
    from the shared-memory image `img` (bf16 elements): element (r, k) at
    start + (r//8) * sbo + (k//8) * lbo + (r%8) * 16 + (k%8) * 2."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    byte = start + (r // 8) * sbo + (k // 8) * lbo + (r % 8) * 16 + (k % 8) * 2
    return img[byte // 2]


@pytest.mark.parametrize("C", ops.BROADCAST_WIDTHS)
def test_broadcast_packed_weights_unpack_to_the_originals(C):
    w = _bc_weights(C, seed=C)
    packed = ops.pack_broadcast(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (2 * C * C + 384 * 384,) == (ops.broadcast_packed_size(C),)
    wf, wdt, wl = ops.unpack_broadcast(packed, C)
    for got, want in ((wf, w.wf), (wdt, w.wdt), (wl, w.wl)):
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (2, 361, C))
                         .astype(np.float32)).bfloat16()
    unpacked = w._replace(wf=wf, wdt=wdt, wl=wl, packed=packed)
    assert torch.equal(ops.trunk_broadcast_reference(x, unpacked),
                       ops.trunk_broadcast_reference(x, w))


@pytest.mark.parametrize("C", ops.BROADCAST_WIDTHS)
def test_broadcast_packed_chunks_sit_where_the_descriptor_reads(C):
    """Each k16 step of conv_first, conv_last and the mix, read from the
    packed image with the kernel's descriptors (w_desc: LBO 128, SBO C/8 *
    128; wdt_desc: LBO 128, SBO 512 within a 64 x 32 chunk), is the operand
    the product needs: B^T [n][k] of Wf with K in reduce_k_order, of Wl with
    N in reduce_k_order, and A [q][p] of WdT."""
    w = _bc_weights(C, seed=C + 1)
    img = ops.pack_broadcast(w).view(torch.int16)
    order = ops.reduce_k_order(C)
    wf, wl, wdt = (t.view(torch.int16) for t in (w.wf, w.wl, w.wdt))
    for ks in range(C // 16):
        k = torch.arange(16 * ks, 16 * ks + 16)
        assert torch.equal(_desc_read(img, ks * 256, 128, C // 8 * 128, C),
                           wf[order[k]].t())
        assert torch.equal(_desc_read(img[C * C:], ks * 256, 128, C // 8 * 128, C),
                           wl[k][:, order].t())
    stream = img[2 * C * C:]
    per_tile = ops.MIX_PAD // ops.MIX_CHUNK_COLS
    for t in range(6):
        for c in range(per_tile):
            chunk = stream[(t * per_tile + c) * 64 * 32:]
            for ks in range(2):
                p = 32 * c + 16 * ks
                assert torch.equal(_desc_read(chunk, ks * 256, 128, 512, 64),
                                   wdt[64 * t:64 * t + 64, p:p + 16])


@pytest.mark.parametrize("C", ops.BROADCAST_WIDTHS)
def test_broadcast_m_stores_meet_the_mix_descriptor(C):
    """conv_first's accumulators (element d[4j + 2h + e] of lane l of warp
    wq: row 64 T + 16 wq + l//4 + 8h, column 8j + 2(l%4) + e), stored by
    `stmatrix .trans` at the kernel's lane addresses (st_addr), give an
    image of m from which the mix's descriptor (m_desc: LBO 128, SBO 48 *
    128) reads B^T [channel][position] for every k16 step, each position
    and channel written exactly once."""
    m = torch.arange(384 * C, dtype=torch.int32).reshape(384, C)
    img = torch.full((384 * C,), -1, dtype=torch.int32)
    for T in range(6):
        for wq in range(4):
            base = T * 64 + wq * 16
            for jp in range(C // 16):
                addr = []  # the row address each lane gives
                for lane in range(32):
                    mi = lane >> 3
                    addr.append(((mi >> 1) * 48 + base // 8 + (mi & 1)) * 128
                                + (lane & 7) * 16 + jp * 2 * 48 * 128)
                for k in range(4):  # register k: pair block j, row half h
                    j, h = 2 * jp + k // 2, k % 2
                    for lane in range(32):
                        for e in range(2):
                            row, col = 2 * (lane % 4) + e, lane // 4
                            byte = addr[8 * k + row] + col * 2
                            assert img[byte // 2] == -1
                            img[byte // 2] = m[base + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e]
    assert bool((img >= 0).all())
    for s in range(24):
        assert torch.equal(_desc_read(img, s * 256, 128, 48 * 128, C),
                           m[16 * s:16 * s + 16].t())


@pytest.mark.parametrize("name,packed", [("b8c64", True), ("b12c128btl3", True),
                                         ("tiny", False)])
def test_broadcast_weights_carry_the_packed_stream(name, packed):
    """build_trunk_fn packs each broadcast block once for the widths the
    kernel takes; on the CPU the wrapper still runs the plain version."""
    cfg = get_config(name)
    model = build_model(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    fn = build_trunk_fn(cfg, model)
    bcs = [s.weights for s in fn.segments if s.kernel is ops.trunk_broadcast]
    assert bcs
    for w in bcs:
        assert w.wdt.shape == (ops.MIX_PAD, ops.MIX_PAD) == (384, 384)
        assert (w.packed is not None) == packed
        if packed:
            assert torch.equal(w.packed, ops.pack_broadcast(w))
            x = torch.zeros((1, 361, cfg.channels), dtype=torch.bfloat16)
            assert torch.equal(ops.trunk_broadcast(x, w), ops.trunk_broadcast_reference(x, w))


def test_broadcast_wrapper_rejects_a_packed_stream_of_the_wrong_shape():
    w = _bc_weights(64, seed=5)
    w = w._replace(packed=ops.pack_broadcast(w)[:-8])
    with pytest.raises(ValueError):
        ops.trunk_broadcast(torch.zeros((1, 361, 64), dtype=torch.bfloat16), w)
    with pytest.raises(ValueError):
        ops.unpack_broadcast(w.packed, 64)
