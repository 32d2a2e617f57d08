"""The layout the segment kernel (csrc/trunk_segment.cu) reads, held on the
CPU: the packed weight stream (`pack_segment`) unpacks to the weights it
came from and puts each element where the wgmma B descriptor reads it, the
reduce's K order matches what each lane loads, and the M tiling of the
zero-haloed grid covers the board exactly once with every tap in bounds;
at the cluster widths, each block's window of the grid holds every tap of
its tiles and its neighbours' pushes bring it every position it does not
own. For the broadcast kernels (csrc/trunk_broadcast.cu) the packed
weights sit where the descriptors read, and at C = 256 and 384 conv_first's
stores of m meet the mix's descriptor and the channel orders of the three
kernels agree. At tiny's widths (the small kernels) the packed words are
each lane's mma.sync B fragments, the 16-row tiles cover the board once
with every tap in the grid, and conv_first's stores of a group's m meet the
mix's descriptor. All checks are exact."""
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


def _core_offset(n, k, cb, ik):
    """Element offset of B^T[n][k] in a packed chunk of items of ik K rows
    (ik = cb: one item): item k//ik at (k//ik) * cb * ik, in it 8x8 core
    matrices of 128 bytes, core (n//8, kk//8) at ((n//8) * (ik//8) + kk//8)
    * 64 (kk = k % ik)."""
    item, kk = k // ik, k % ik
    return item * cb * ik + ((n // 8) * (ik // 8) + kk // 8) * 64 + (n % 8) * 8 + kk % 8


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


# The widths whose segment kernel reads its weights by wgmma descriptor.
DESCRIPTOR_WIDTHS = [w for w in ops.SEGMENT_WIDTHS if w != ops.SEGMENT_SMALL]


@pytest.mark.parametrize("C,cb", DESCRIPTOR_WIDTHS)
def test_packed_chunks_sit_where_the_descriptor_reads(C, cb):
    """Chunk order per block: the reduce by K, one chunk per 3x3 tap, the
    expand by N (the reduce's K and the expand's N in reduce_k_order); each
    chunk B^T [n][k] in core matrices, by items of SEGMENT_ITEM_K rows of K
    at (384, 192)."""
    inner, split = 2, C // cb
    ik = ops.SEGMENT_ITEM_K.get((C, cb), cb)
    w = _weights(C, cb, inner, 2, seed=3)
    packed = ops.pack_segment(w).float()
    order = ops.reduce_k_order(C)
    rng = np.random.default_rng(4)
    for blk in range(2):
        for n, k in rng.integers(0, cb, (40, 2)):
            off = _core_offset(n, k, cb, ik)
            for kc in range(split):
                assert packed[blk, kc, off] == w.wr[blk, order[kc * cb + k], n].float()
            for j in range(inner):
                for o in range(9):
                    assert packed[blk, split + 9 * j + o, off] == \
                        w.w9[blk, j, o * cb + k, n].float()
            for nc in range(split):
                assert packed[blk, split + 9 * inner + nc, off] == \
                    w.we[blk, k, order[nc * cb + n]].float()


@pytest.mark.parametrize("C", [64, 128, 256, 384])
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


@pytest.mark.parametrize("name", ["b8c64", "tiny"])
def test_trunk_weights_carry_the_packed_stream(name):
    """build_trunk_fn packs each segment once, at its own width (tiny's
    (16, 8) too: its kernel is its own); on the CPU the wrapper still runs
    the plain version."""
    cfg = get_config(name)
    model = build_model(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    fn = build_trunk_fn(cfg, model)
    segs = [s.weights for s in fn.segments if s.kernel is ops.trunk_segment]
    assert segs
    for w in segs:
        assert w.packed is not None
        assert tuple(w.wr.shape[1:]) == (cfg.channels, cfg.bottleneck_channels)
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


def _b_from_words(words):
    """The [K, N] B operand that mma.sync reads from the lanes' fragment
    words [N/8 n-tiles, K/8 k-groups, 32 lanes, 2 halves], by the PTX ISA's
    layout: lane l (g = l // 4, t = l % 4) holds (k 8 kg + 2t + e, n 8 nt + g)
    in half e of its word of k-group kg, n-tile nt."""
    nt, kg = words.shape[:2]
    b = torch.full((8 * kg, 8 * nt), -12345, dtype=words.dtype)
    for n in range(nt):
        for k in range(kg):
            for lane in range(32):
                for e in range(2):
                    b[8 * k + 2 * (lane % 4) + e, 8 * n + lane // 4] = words[n, k, lane, e]
    assert not bool((b == -12345).any())
    return b


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
    packed image with the kernels' descriptors, is the operand the product
    needs. At C = 64, 128 (w_desc: LBO 128, SBO C/8 * 128; wdt_desc: LBO
    128, SBO 512 within a 64 x 32 chunk): B^T [n][k] of Wf with K in
    reduce_k_order, of Wl with N in reduce_k_order, and A [q][p] of WdT.
    At C = 256, 384 (item_desc: LBO 128, SBO 1024 within an item of
    BROADCAST_ITEM_WF or _WL = (n, 64); wdt_tile_desc: LBO 128, SBO 48 * 128
    within a 64-row tile): B^T [n][k] of Wf and of Wl with K and N in
    reduce_k_order, item (n tile, K chunk) at (nt * C/64 + kc) * n * 64, and
    WdT's tile t at t * 24576. At C = 16 (the small kernel): Wf and Wl as mma
    B fragment words, WdT's stream as at C = 64, 128."""
    w = _bc_weights(C, seed=C + 1)
    img = ops.pack_broadcast(w).view(torch.int16)
    order = ops.reduce_k_order(C) if C % 32 == 0 else None
    wf, wl, wdt = (t.view(torch.int16) for t in (w.wf, w.wl, w.wdt))
    if C == ops.BROADCAST_SMALL:
        # Wf and Wl as the lanes' mma B fragment words (no descriptor):
        # Wf's K in small_k_order, Wl's N; then WdT's stream as below.
        small, nat = ops.small_k_order(), torch.arange(C)
        assert torch.equal(_b_from_words(img[:C * C].reshape(2, 2, 32, 2)), wf[small][:, nat])
        assert torch.equal(_b_from_words(img[C * C:2 * C * C].reshape(2, 2, 32, 2)),
                           wl[nat][:, small])
    elif C in ops.BROADCAST_WIDE:
        for mat, base, (n_item, k_item) in ((wf, 0, ops.BROADCAST_ITEM_WF),
                                            (wl, C * C, ops.BROADCAST_ITEM_WL)):
            for nt in range(C // n_item):
                for kc in range(C // k_item):
                    item = img[base + (nt * (C // k_item) + kc) * n_item * k_item:]
                    n = order[nt * n_item:(nt + 1) * n_item]
                    for kk in range(k_item // 16):
                        k = order[kc * k_item + 16 * kk:kc * k_item + 16 * kk + 16]
                        assert torch.equal(_desc_read(item, kk * 256, 128, 1024, n_item),
                                           mat[k][:, n].t())
        for t in range(6):
            tile = img[2 * C * C + t * 64 * 384:]
            for s in range(24):
                assert torch.equal(_desc_read(tile, s * 256, 128, 48 * 128, 64),
                                   wdt[64 * t:64 * t + 64, 16 * s:16 * s + 16])
        return
    else:
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


@pytest.mark.parametrize("C", [64, 128])
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


@pytest.mark.parametrize("name", ["b8c64", "b12c128btl3", "tiny"])
def test_broadcast_weights_carry_the_packed_stream(name):
    """build_trunk_fn packs each broadcast block once, at its own width
    (tiny's 16 too); on the CPU the wrapper still runs the plain version."""
    cfg = get_config(name)
    model = build_model(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    fn = build_trunk_fn(cfg, model)
    bcs = [s.weights for s in fn.segments if s.kernel is ops.trunk_broadcast]
    assert bcs
    for w in bcs:
        assert w.wdt.shape == (ops.MIX_PAD, ops.MIX_PAD) == (384, 384)
        assert w.packed is not None and w.wf.shape == (cfg.channels, cfg.channels)
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


# ---- the cluster kernels (C = 256 and 384) ---------------------------------

@pytest.mark.parametrize("C,cb", list(ops.SEGMENT_CLUSTER))
def test_cluster_windows_hold_every_tap(C, cb):
    """A segment cluster of R blocks: block r owns the TB = 6/R tiles from
    r*TB; the windows (`cluster_window`) fit the kernel's buffers, hold
    every tap row of the block's tiles (pad rows read position 360), every
    board position such a tap reads is owned by the block or by a neighbour
    r +- 1, and that neighbour's window holds the position's row, so its
    owner stores it there. Halo rows inside a window are never written."""
    R = ops.SEGMENT_CLUSTER[(C, cb)]
    tb = 6 // R
    tiles = ops.segment_tile_positions()
    owner = {}
    for r in range(R):
        for p in tiles[r * tb:(r + 1) * tb].flatten().tolist():
            if p >= 0:
                owner[p] = r
    assert sorted(owner) == list(range(361))
    windows = [ops.cluster_window(r, tb) for r in range(R)]
    rows = max(n for _, n in windows)
    assert rows == {2: 13, 3: 10}[R] * 21  # the kernel's kWinRows
    for r, (first, n) in enumerate(windows):
        mine = tiles[r * tb:(r + 1) * tb].flatten()
        p = torch.where(mine >= 0, mine, 360)
        for shift in ops.TAP_SHIFTS:
            row = ops.halo_row(p) + shift
            assert int(row.min()) >= first and int(row.max()) < first + n
            hi, hj = row // 21, row % 21
            inside = (hi >= 1) & (hi <= 19) & (hj >= 1) & (hj <= 19)
            for g in row[inside].tolist():
                q = (g // 21 - 1) * 19 + g % 21 - 1
                src = owner[q]
                assert abs(src - r) <= 1
                if src != r:
                    assert first <= ops.halo_row(torch.tensor(q)) < first + n


@pytest.mark.parametrize("C,cb", list(ops.SEGMENT_CLUSTER))
def test_cluster_items_sit_where_the_descriptor_reads(C, cb):
    """The cluster kernel streams each chunk as items of ik K rows (the
    whole chunk at (256, 128), a third at (384, 192)) and every consumer
    group (a tile over all cb output columns) reads every item: k16 step kk
    of item i, read with the item's descriptor (LBO 128, SBO ik/8 * 128),
    is B^T rows 0 .. cb - 1, K rows i ik + 16 kk .. +15; the rows of any
    64-column slice n0 sit n0 * ik elements into the item."""
    ns = 64
    ik = ops.SEGMENT_ITEM_K.get((C, cb), cb)
    w = _weights(C, cb, 1, 1, seed=7)
    packed = ops.pack_segment(w).view(torch.int16)
    wr, w9, we = (t.view(torch.int16) for t in ops.unpack_segment(packed.view(torch.bfloat16),
                                                                  C, 1))
    order = ops.reduce_k_order(C)
    bts = [wr[0, order[kc * cb:(kc + 1) * cb]].t() for kc in range(C // cb)]
    bts += [w9[0, 0, o * cb:(o + 1) * cb].t() for o in range(9)]
    bts += [we[0][:, order[nc * cb:(nc + 1) * cb]].t() for nc in range(C // cb)]
    assert packed.shape[1] == len(bts) == 2 * (C // cb) + 9
    for c, bt in enumerate(bts):  # B^T [n][k] of chunk c
        for i in range(cb // ik):
            item = packed[0, c, i * cb * ik:(i + 1) * cb * ik]
            for kk in range(ik // 16):
                k = i * ik + 16 * kk
                assert torch.equal(_desc_read(item, kk * 256, 128, ik // 8 * 128, cb),
                                   bt[:, k:k + 16])
                for n0 in range(0, cb, ns):
                    assert torch.equal(_desc_read(item[n0 * ik:], kk * 256, 128,
                                                  ik // 8 * 128, ns),
                                       bt[n0:n0 + ns, k:k + 16])


def _m_offset(C, t, c, p):
    """Element offset of m[channel c][position 64 t + p] in one board's
    block of the wide kernels' m scratch [6, C/8, 8, 64]: chunk t, channel
    core c // 8, position core p // 8, row c % 8, column p % 8."""
    return ((t * (C // 8) + c // 8) * 8 + p // 8) * 64 + (c % 8) * 8 + p % 8


@pytest.mark.parametrize("C", list(ops.BROADCAST_WIDE))
def test_wide_broadcast_m_stores_meet_the_mix_descriptor(C):
    """conv_first at C = 256, 384: the accumulators of a 64-column pass nt
    (BROADCAST_ITEM_WF; element d[4j + 2h + e] of lane l of warp wq: row
    16 wq + l//4 + 8h of tile t, column 8j + 2(l%4) + e), stored by
    `stmatrix .trans` at the kernel's lane addresses into the 8 KB staging
    tile and copied whole to m at ((t * C/8) + 8 nt) * 512, give one
    board's m, every element written once; the mix reads each 128-channel item (tile t, channel tile
    ct, 16 KB at (t * C/8 + 16 ct) * 512) with item_desc (LBO 128, SBO 1024)
    as B^T [128 channel rows][16 positions] of each k16 step."""
    n_tile = ops.BROADCAST_ITEM_WF[0]
    m = torch.arange(384 * C, dtype=torch.int32).reshape(384, C)  # m[position][column]
    img = torch.full((384 * C,), -1, dtype=torch.int32)
    for t in range(6):
        for nt in range(C // n_tile):
            staging = torch.full((n_tile * 64,), -1, dtype=torch.int32)
            for wq in range(4):
                for jp in range(n_tile // 16):
                    addr = []
                    for lane in range(32):
                        mi = lane >> 3
                        addr.append(((mi >> 1) * 8 + 2 * wq + (mi & 1)) * 128
                                    + (lane & 7) * 16 + jp * 2 * 8 * 128)
                    for k in range(4):
                        j, h = 2 * jp + k // 2, k % 2
                        for lane in range(32):
                            for e in range(2):
                                row, col = 2 * (lane % 4) + e, lane // 4
                                byte = addr[8 * k + row] + col * 2
                                assert staging[byte // 2] == -1
                                staging[byte // 2] = m[64 * t + 16 * wq + lane // 4 + 8 * h,
                                                       n_tile * nt + 8 * j + 2 * (lane % 4) + e]
            assert bool((staging >= 0).all())
            start = (t * (C // 8) + nt * (n_tile // 8)) * 512
            img[start:start + n_tile * 64] = staging
    assert bool((img >= 0).all())
    rng = np.random.default_rng(C)
    for c, p in rng.integers(0, [C, 384], (64, 2)):
        assert img[_m_offset(C, p // 64, c, p % 64)] == m[p, c]
    for t in range(6):
        for ct in range(C // 128):
            item = img[(t * (C // 8) + 16 * ct) * 512:]
            for kk in range(4):
                assert torch.equal(_desc_read(item, kk * 256, 128, 1024, 128),
                                   m[64 * t + 16 * kk:64 * t + 16 * kk + 16,
                                     128 * ct:128 * ct + 128].t())


@pytest.mark.parametrize("C", list(ops.BROADCAST_WIDE))
def test_wide_broadcast_channel_orders_agree(C):
    """At C = 256, 384 m's rows hold the channels in reduce_k_order (Wf's N
    is packed so), and the mix's lane t4 holds, in each 32-column group qq
    of a 128-channel pass ct, accumulator columns 8j + 2 t4 + e (j = 4 qq ..
    4 qq + 3), which are the 8 contiguous channels 128 ct + 32 qq + 8 t4 ..
    +7 that its 16-byte store of act(z) writes; conv_last's N (Wl's) is in
    the same order, so its lane's columns are the 8 contiguous channels of
    its residual and output."""
    order = ops.reduce_k_order(C)
    w = _bc_weights(C, seed=C + 9)
    n_item, k_item = ops.BROADCAST_ITEM_WF
    img = ops.pack_broadcast(w).view(torch.int16)
    wf = w.wf.view(torch.int16)
    for ct in range(C // 128):
        for qq in range(4):
            for t4 in range(4):
                cols = [128 * ct + 8 * j + 2 * t4 + e
                        for j in range(4 * qq, 4 * qq + 4) for e in (0, 1)]
                first = 128 * ct + 32 * qq + 8 * t4
                assert [int(order[n]) for n in cols] == list(range(first, first + 8))
    # conv_first's output column n (m's row n) is Wf's column order[n]: the
    # first k16 step of every n tile holds it.
    for nt in range(C // n_item):
        item = img[nt * (C // k_item) * n_item * k_item:]
        got = _desc_read(item, 0, 128, 1024, n_item)
        assert torch.equal(got, wf[order[:16]][:, order[nt * n_item:(nt + 1) * n_item]].t())


# ---- the small kernels (tiny: (16, 8), C = 16) -----------------------------

def test_small_k_order_matches_the_lanes_loads():
    """Lane t of a quad loads channels 4t .. 4t + 3 of a row as two bf16
    pairs: logical k (2t, 2t + 1) and (2t + 8, 2t + 9) of the m16n8k16 A
    fragment. A 16-channel output's n-tile j puts columns 2t, 2t + 1 in the
    same lane: channels 4t + 2j, 4t + 2j + 1, so the lane's four outputs
    are the four channels it loaded."""
    order = ops.small_k_order().tolist()
    assert sorted(order) == list(range(16))
    for t in range(4):
        loaded = list(range(4 * t, 4 * t + 4))
        assert [order[k] for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)] == loaded
        assert [order[8 * j + 2 * t + e] for j in (0, 1) for e in (0, 1)] == loaded


@pytest.mark.parametrize("inner,nb", [(0, 1), (1, 3), (2, 2), (3, 1)])
def test_small_packed_words_are_the_mma_fragments(inner, nb):
    """At (16, 8) each block's 4 + 9 inner 64-element groups are B fragment
    words (`_b_from_words`): the reduce's two k-groups (Wr with K in
    small_k_order), per 3x3 layer one k-group a tap (W9's rows of tap o),
    the expand's two n-tiles (We with N in small_k_order)."""
    C, cb = ops.SEGMENT_SMALL
    w = _weights(C, cb, inner, nb, seed=20 + inner)
    packed = ops.pack_segment(w).view(torch.int16)
    assert packed.shape == (nb, 4 + 9 * inner, 64)
    small = ops.small_k_order()
    for blk in range(nb):
        words = packed[blk].reshape(-1, 32, 2)
        assert torch.equal(_b_from_words(words[None, :2]), w.wr[blk].view(torch.int16)[small])
        for j in range(inner):
            assert torch.equal(_b_from_words(words[None, 2 + 9 * j:11 + 9 * j]),
                               w.w9[blk, j].view(torch.int16))
        assert torch.equal(_b_from_words(words[2 + 9 * inner:, None]),
                           w.we[blk].view(torch.int16)[:, small])


def _small_tiles():
    """{warp: [its M tiles]} of the small segment kernel: warp w owns tiles
    w, w + SMALL_WARPS, ... of the 24 16-row tiles."""
    tiles = 384 // ops.SMALL_TILE_ROWS
    return {w: list(range(w, tiles, ops.SMALL_WARPS)) for w in range(ops.SMALL_WARPS)}


def test_small_tiles_cover_every_position_once():
    """Each warp's tiles hold rows 16 tile + 0 .. 15; over the block every
    position 0 .. 360 is one lane row of one tile, the 23 pad rows are the
    tail (tile 22's last 7, tile 23 whole, which holds no position)."""
    rows = [16 * t + r for w, ts in _small_tiles().items() for t in ts for r in range(16)]
    assert sorted(rows) == list(range(384))
    live = [t for ts in _small_tiles().values() for t in ts if 16 * t < 361]
    assert sorted(live) == list(range(23))


def test_small_tap_addresses_stay_in_the_haloed_buffer():
    """The small kernel's ldmatrix rows: lane l of a tile gives row
    halo_row(min(16 tile + l % 16, 360)) shifted by tap 2k + l // 16 (an x4
    load of tap pair k) or by tap 8 (an x2 load, lanes 0 .. 15): inside the
    21x21 grid, the neighbour of the lane's position, and a halo row
    exactly when that neighbour is off the board."""
    for t in range(23):
        for lane in range(32):
            p = min(16 * t + lane % 16, 360)
            i, j = p // 19, p % 19
            taps = [2 * k + lane // 16 for k in range(4)] + ([8] if lane < 16 else [])
            for o in taps:
                di, dj = o // 3 - 1, o % 3 - 1
                r = int(ops.halo_row(torch.tensor(p))) + ops.TAP_SHIFTS[o]
                assert 0 <= r < ops.HALO_ROWS
                assert r == (i + di + 1) * 21 + (j + dj + 1)
                off = not (0 <= i + di <= 18 and 0 <= j + dj <= 18)
                assert off == (r // 21 in (0, 20) or r % 21 in (0, 20))


def test_small_broadcast_m_stores_meet_the_mix_descriptor():
    """The small broadcast kernel's conv_first: warp w's unit k is board
    k // 2 of the group, rows 16 s .. 16 s + 15, s = w + 12 (k % 2); its
    mma accumulators (n-tile j, element e of pair h: row 16 s + l // 4 +
    8 h, channel 8 j + 2 (l % 4) + e of lane l) stored by `stmatrix .trans`
    at the kernel's lane addresses give an image of the group's m from which
    the mix's descriptor (m_desc: LBO 128, SBO 48 * 128, N = 128 rows)
    reads B^T [16 board + channel][position] for every k16 step, each
    element written exactly once."""
    G, C = ops.SMALL_GROUP, ops.BROADCAST_SMALL
    m = torch.arange(G * 384 * C, dtype=torch.int32).reshape(G, 384, C)
    img = torch.full((G * C * 384,), -1, dtype=torch.int32)
    for w in range(12):
        for k in range(2 * G):
            b, s = k // 2, w + 12 * (k % 2)
            addr = []  # the row address each lane gives
            for lane in range(32):
                mi = lane >> 3
                addr.append(((2 * b + (mi >> 1)) * 48 + 2 * s + (mi & 1)) * 128
                            + (lane & 7) * 16)
            for reg in range(4):  # matrix reg: n-tile reg // 2, row half reg % 2
                j, h = reg // 2, reg % 2
                for lane in range(32):
                    for e in range(2):
                        row, col = 2 * (lane % 4) + e, lane // 4
                        byte = addr[8 * reg + row] + col * 2
                        assert img[byte // 2] == -1
                        img[byte // 2] = m[b, 16 * s + lane // 4 + 8 * h, 8 * j + 2 * (lane % 4) + e]
    assert bool((img >= 0).all())
    bt = m.permute(0, 2, 1).reshape(G * C, 384)  # B^T [16 b + c][position]
    for step in range(24):
        assert torch.equal(_desc_read(img, step * 256, 128, 48 * 128, G * C),
                           bt[:, 16 * step:16 * step + 16])
