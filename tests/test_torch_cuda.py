"""The PyTorch port's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips where there is no card. The
file imports no JAX, so it also runs on a machine that has a card and nvcc
but no JAX (the repo's conftest imports JAX, hence `--noconftest`):

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import ctypes

import numpy as np
import pytest
import torch

from chip_smoke import (EPILOGUE_MODES, KERNEL_TOL, SERVE_Q_CALIB_BF16_RTOL, SERVE_Q_CALIB_RTOL,
                        SERVE_Q_NATIVE_TOL, SERVE_Q_SITES, SERVE_Q_WIDTHS, calibration_boards,
                        check_conv_i8, conv_i8_case, cuda_kernel_counts, epilogue_case,
                        random_boards, rel_err, seeded_model)
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import from_stones, legal_mask_batch, map_state
from p3achygo_tpu_torch.game.scoring import compute_pass_alive
from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
from p3achygo_tpu_torch.models.blocks import Broadcast, ConvBlock, mish
from p3achygo_tpu_torch.models.config import ModelConfig
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.models.model import block_name, build_model, init_params
from p3achygo_tpu_torch.nn.serve import ServeNet
from p3achygo_tpu_torch.nn.serve_q import ServeQNet, calibrate
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn
from p3achygo_tpu_torch.ops import conv_i8 as ci
from p3achygo_tpu_torch.ops.cuda_build import load_library
from p3achygo_tpu_torch.ops import liberties as tl
from p3achygo_tpu_torch.ops import preact as pa
from p3achygo_tpu_torch.ops import trunk as tk
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.rl.config import RunConfig
from p3achygo_tpu_torch.rl.loop import GenerationLoop
from p3achygo_tpu_torch.selfplay.fork import ForkEvaluator, _Position
from p3achygo_tpu_torch.selfplay.loop import final_scores, make_aux, make_game_buffer, reset_finished
from p3achygo_tpu_torch.train.optimizer import sgd_nesterov
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step
from probe_trunk import seeded_broadcast, seeded_segment

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


# Every width the trunk kernels take: (64, 32) / 64 and (128, 64) / 128 a
# board a block; (256, 128) and (384, 192) a board over a cluster, 256 and
# 384 a broadcast block as three kernels; tiny's (16, 8) / 16 on kernels of
# their own (a board a small block; eight boards a mix).
TRUNK_NAMES = ["b8c64", "b12c128btl3", "b12c256btl3", "b14c384btl3", "tiny"]
CLUSTER_NAMES = ["b12c256btl3", "b14c384btl3"]


@pytest.fixture(scope="module")
def trunks(device):
    """{config: trunk_fn} with seeded random weights and perturbed BN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    return {name: build_trunk_fn(m.config, m) for name in TRUNK_NAMES
            for m in [seeded_model(name, device, gen)]}


@pytest.mark.parametrize("name", TRUNK_NAMES)
@pytest.mark.parametrize("N", [1, 7, 64, 133, 2880])
def test_trunk_kernels_equal_plain(trunks, device, name, N):
    """Each kernel call against its plain version on the same input; only
    the f32 summation order differs (chip_smoke.KERNEL_TOL says how far
    that carries). N = 133 is more boards than the card has SMs and not a
    multiple of the persistent grid; 2880 is the widest leaf batch."""
    fn = trunks[name]
    channels = fn.segments[0].weights.wr.shape[1]
    gen = torch.Generator(device=device).manual_seed(N)
    x = torch.randn((N, 361, channels), generator=gen, device=device).to(torch.bfloat16)
    for kern, plain, w in fn.segments:
        before = kern.launches
        got = kern(x, w)
        want = plain(x, w)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert bool(torch.isfinite(got.float()).all())
        assert rel_err(got, want)[1] <= KERNEL_TOL, (kern.__name__, rel_err(got, want))
        x = want


@pytest.mark.parametrize("name", CLUSTER_NAMES)
@pytest.mark.parametrize("N", [1, 2, 5, 13, 133, 512])
def test_cluster_kernels_below_and_off_the_cluster_size(trunks, device, name, N):
    """The kernels of the C = 256 / 384 widths (the segment over a cluster
    of 2 / 3 blocks; the broadcast block as three kernels, conv_first's
    and conv_last's units a board's 64-position tile, two or three a block
    pass, the mix's grid even) on fewer boards than a cluster, a block pass
    or the persistent grid, on counts that are no multiple of them and on
    more boards than the grid: every board computed, equal to the plain
    version."""
    fn = trunks[name]
    channels = fn.segments[0].weights.wr.shape[1]
    gen = torch.Generator(device=device).manual_seed(20 + N)
    x = torch.randn((N, 361, channels), generator=gen, device=device).to(torch.bfloat16)
    for kern, plain, w in fn.segments:
        got = kern(x, w)
        want = plain(x, w)
        torch.cuda.synchronize()
        for b in range(N):
            assert rel_err(got[b], want[b])[1] <= KERNEL_TOL, (kern.__name__, b)
        x = want


@pytest.mark.parametrize("name", CLUSTER_NAMES)
def test_wide_kernels_launch_nothing_for_an_empty_batch(trunks, device, name):
    """N = 0 at the C = 256 / 384 widths: an empty result of the input's
    shape, no launch of either kernel."""
    fn = trunks[name]
    before = (tk.trunk_segment.launches, tk.trunk_broadcast.launches)
    for kern, _, w in fn.segments:
        channels = fn.segments[0].weights.wr.shape[1]
        out = kern(torch.zeros((0, 361, channels), dtype=torch.bfloat16, device=device), w)
        assert out.shape == (0, 361, channels) and out.dtype == torch.bfloat16
    assert (tk.trunk_segment.launches, tk.trunk_broadcast.launches) == before


@pytest.mark.parametrize("C,cb", list(tk.SEGMENT_CLUSTER))
def test_cluster_pushes_bring_every_halo_row(device, C, cb):
    """After a layer, block s of a segment cluster pushes the grid rows the
    built kernel computes (`p3_trunk_segment_cluster_rows`: one contiguous
    range, the same rows in both windows) to each neighbour r: the range
    lies in both windows, holds only positions s owns (and halo cells, zero
    in both), and every position of s that a tap of r's tiles reads is in
    it. The kernel's windows are `tk.cluster_window`'s. The bytes fit a bulk
    copy (rows of (Cb + 8) * 2 bytes, a multiple of 16)."""
    fn = load_library(tk.SEGMENT_SOURCE).p3_trunk_segment_cluster_rows
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = None
    R = tk.SEGMENT_CLUSTER[(C, cb)]
    tb = 6 // R

    def kernel_rows(rank, src, dst):
        out = (ctypes.c_int * 4)()
        fn(rank, src, dst, tb, out)
        return tuple(out)

    assert (cb + 8) * 2 % 16 == 0
    tiles = tk.segment_tile_positions()
    owner = {p: r for r in range(R) for p in tiles[r * tb:(r + 1) * tb].flatten().tolist()
             if p >= 0}
    windows = [kernel_rows(r, 0, 0)[:2] for r in range(R)]
    assert windows == [tk.cluster_window(r, tb) for r in range(R)]
    for r in range(R):
        mine = tiles[r * tb:(r + 1) * tb].flatten()
        p = torch.where(mine >= 0, mine, 360)
        read = set()
        for shift in tk.TAP_SHIFTS:
            for g in (tk.halo_row(p) + shift).tolist():
                hi, hj = g // 21, g % 21
                if 1 <= hi <= 19 and 1 <= hj <= 19:
                    read.add((hi - 1) * 19 + hj - 1)
        for s in range(R):
            if s == r:
                continue
            first, n = kernel_rows(0, s, r)[2:]
            needed = {q for q in read if owner[q] == s}
            assert bool(needed) == (abs(s - r) == 1) == (n > 0)
            if n == 0:
                continue
            for w_first, w_rows in (windows[s], windows[r]):
                assert w_first <= first and first + n <= w_first + w_rows
            pushed = set()
            for g in range(first, first + n):
                hi, hj = g // 21, g % 21
                if 1 <= hi <= 19 and 1 <= hj <= 19:
                    q = (hi - 1) * 19 + hj - 1
                    assert owner[q] == s
                    pushed.add(q)
            assert needed <= pushed


@pytest.mark.parametrize("name", TRUNK_NAMES)
def test_segment_kernel_is_deterministic(trunks, device, name):
    """No atomics: two calls on the same input give identical bits."""
    seg = trunks[name].segments[0]
    channels = seg.weights.wr.shape[1]
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((300, 361, channels), generator=gen, device=device).to(torch.bfloat16)
    first = tk.trunk_segment(x, seg.weights)
    second = tk.trunk_segment(x, seg.weights)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.parametrize("name", TRUNK_NAMES)
def test_segment_launches_count_one_per_call(trunks, device, name):
    w = trunks[name].segments[0].weights
    x = torch.zeros((5, 361, w.wr.shape[1]), dtype=torch.bfloat16, device=device)
    before = tk.trunk_segment.launches
    for i in range(1, 4):
        tk.trunk_segment(x, w)
        assert tk.trunk_segment.launches == before + i
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", TRUNK_NAMES)
def test_broadcast_kernel_is_deterministic(trunks, device, name):
    """No atomics: two calls on the same input give identical bits."""
    bc = next(s for s in trunks[name].segments if s.kernel is tk.trunk_broadcast)
    channels = bc.weights.wf.shape[0]
    gen = torch.Generator(device=device).manual_seed(12)
    x = torch.randn((300, 361, channels), generator=gen, device=device).to(torch.bfloat16)
    first = tk.trunk_broadcast(x, bc.weights)
    second = tk.trunk_broadcast(x, bc.weights)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.parametrize("name", TRUNK_NAMES)
def test_broadcast_launches_count_one_per_call(trunks, device, name):
    bc = next(s for s in trunks[name].segments if s.kernel is tk.trunk_broadcast)
    x = torch.zeros((5, 361, bc.weights.wf.shape[0]), dtype=torch.bfloat16, device=device)
    before = tk.trunk_broadcast.launches
    for i in range(1, 4):
        tk.trunk_broadcast(x, bc.weights)
        assert tk.trunk_broadcast.launches == before + i
    torch.cuda.synchronize()


def test_broadcast_kernel_needs_the_packed_weights(trunks, device):
    """On the card the wrapper raises without `packed`; it never falls back
    to the plain version."""
    bc = next(s for s in trunks["b8c64"].segments if s.kernel is tk.trunk_broadcast)
    x = torch.zeros((2, 361, 64), dtype=torch.bfloat16, device=device)
    before = tk.trunk_broadcast.launches
    with pytest.raises(ValueError):
        tk.trunk_broadcast(x, bc.weights._replace(packed=None))
    assert tk.trunk_broadcast.launches == before


def test_trunk_empty_batch_launches_nothing(trunks, device):
    fn = trunks["b8c64"]
    before = (tk.trunk_segment.launches, tk.trunk_broadcast.launches)
    out = fn(torch.zeros((0, 19, 19, 64), device=device))
    assert out.shape == (0, 19, 19, 64) and out.dtype == torch.bfloat16
    assert (tk.trunk_segment.launches, tk.trunk_broadcast.launches) == before


def test_trunk_rejects_non_contiguous(trunks, device):
    seg, bc = (s.weights for s in trunks["b8c64"].segments[:2])
    x = torch.zeros((4, 361, 128), dtype=torch.bfloat16, device=device)[:, :, ::2]
    with pytest.raises(ValueError):
        tk.trunk_segment(x, seg)
    with pytest.raises(ValueError):
        tk.trunk_broadcast(x, bc)


# tiny's own kernels (ops.trunk SEGMENT_SMALL, BROADCAST_SMALL) on seeded
# weights (probe_trunk.seeded_segment / seeded_broadcast): every N of the
# main path's shapes, the segment with 1 to MAX_INNER inner layers, and the
# broadcast block's ragged last group of SMALL_GROUP boards.
SMALL_N = [0, 1, 2, 5, 13, 133, 512, 2880]
RAGGED_N = [tk.SMALL_GROUP * k + d for k in (1, 3, 17) for d in (-1, 1)]


def _small_case(kern, plain, w, x):
    """kern against plain on x: one launch (none at N = 0), the input's
    shape and type, every board within KERNEL_TOL (the first 133 board by
    board, then the whole)."""
    before = kern.launches
    got, want = kern(x, w), plain(x, w)
    torch.cuda.synchronize()
    assert kern.launches == before + (x.shape[0] > 0)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    if x.shape[0] == 0:
        return
    assert bool(torch.isfinite(got.float()).all())
    for b in range(min(x.shape[0], 133)):
        assert rel_err(got[b], want[b])[1] <= KERNEL_TOL, (kern.__name__, b)
    assert rel_err(got, want)[1] <= KERNEL_TOL


@pytest.mark.parametrize("inner", [1, 2, 3])
@pytest.mark.parametrize("N", SMALL_N)
def test_small_segment_equals_plain(device, inner, N):
    gen = torch.Generator(device=device).manual_seed(40 + inner)
    w = seeded_segment(*tk.SEGMENT_SMALL, inner, gen)
    x = torch.randn((N, 361, 16), generator=gen, device=device).to(torch.bfloat16)
    _small_case(tk.trunk_segment, tk.trunk_segment_reference, w, x)


@pytest.mark.parametrize("N", SMALL_N + RAGGED_N)
def test_small_broadcast_equals_plain(device, N):
    gen = torch.Generator(device=device).manual_seed(50)
    w = seeded_broadcast(tk.BROADCAST_SMALL, gen)
    x = torch.randn((N, 361, 16), generator=gen, device=device).to(torch.bfloat16)
    _small_case(tk.trunk_broadcast, tk.trunk_broadcast_reference, w, x)


def test_small_kernels_are_deterministic(device):
    """No atomics: two calls on the same input give identical bits."""
    gen = torch.Generator(device=device).manual_seed(60)
    x = torch.randn((300, 361, 16), generator=gen, device=device).to(torch.bfloat16)
    for kern, w in ((tk.trunk_segment, seeded_segment(*tk.SEGMENT_SMALL, 2, gen)),
                    (tk.trunk_broadcast, seeded_broadcast(tk.BROADCAST_SMALL, gen))):
        first, second = kern(x, w), kern(x, w)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16)), kern.__name__


def test_tiny_trunk_launches_only_its_kernels(trunks, device):
    """tiny's fused trunk on a bf16 input runs one kernel a wrapper call and
    no other kernel (no pad or slice): its plan's two segment kernels and
    one broadcast kernel."""
    fn = trunks["tiny"]
    x = torch.randn((64, 19, 19, 16), device=device).to(torch.bfloat16)
    got = cuda_kernel_counts(lambda: fn(x), 5)
    assert got == {"trunk_segment_small_kernel<16,8>": 2,
                   "trunk_broadcast_small_kernel<16>": 1}, got


def test_trunk_unsupported_width_raises(device):
    """C = 512 (Cb = 256) is a btl width no trunk kernel takes: building
    the fused trunk on the card raises, naming it, and the wrappers given
    its weights raise; nothing is launched and nothing falls back to the
    plain version."""
    cfg = ModelConfig(blocks=2, broadcast_interval=2, inner_bottleneck_layers=1,
                      channels=512, bottleneck_channels=256, head_channels=8, c_val=8)
    m = build_model(cfg, torch.float32, device)
    init_params(m, torch.Generator().manual_seed(0))
    before = (tk.trunk_segment.launches, tk.trunk_broadcast.launches)
    with pytest.raises(ValueError, match="512"):
        build_trunk_fn(cfg, m)
    with pytest.raises(ValueError, match="512"):
        make_eval_fn(m, use_fused_trunk=True)
    cpu = build_model(cfg, torch.float32, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    segments = build_trunk_fn(cfg, cpu).segments
    seg = tk.SegmentWeights(*[t.to(device) for t in segments[0].weights[:4]])
    bc = tk.BroadcastWeights(*[t.to(device) for t in segments[1].weights[:6]])
    x = torch.zeros((2, 361, 512), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError):
        tk.trunk_segment(x, seg)
    with pytest.raises(ValueError):
        tk.trunk_broadcast(x, bc)
    assert (tk.trunk_segment.launches, tk.trunk_broadcast.launches) == before


def test_fused_eval_on_card_agrees_with_cpu(device, boards):
    """make_eval_fn(use_fused_trunk=True) on the card (kernels) against the
    same on the CPU (plain versions), on the policy's top-1."""
    m = seeded_model("b8c64", device, torch.Generator().manual_seed(6))
    m_cpu = seeded_model("b8c64", "cpu", torch.Generator().manual_seed(6))
    sub = map_state(lambda t: t[:64], boards)
    before = tk.trunk_segment.launches
    card = make_eval_fn(m, use_fused_trunk=True)(sub)
    torch.cuda.synchronize()
    assert tk.trunk_segment.launches > before
    cpu = make_eval_fn(m_cpu, use_fused_trunk=True)(map_state(lambda t: t.cpu(), sub))
    top1 = (card.log_priors.argmax(-1).cpu() == cpu.log_priors.argmax(-1)).float().mean()
    assert float(top1) >= 0.95, float(top1)
    assert float((card.outcome_value.cpu() - cpu.outcome_value).abs().max()) < 0.05


def _replay_rows(states, seed: int):
    """Replay rows (ReplayBuffer.sample's dict) on `states`' positions with
    seeded random targets of every kind."""
    rng = np.random.default_rng(seed)
    n = states.stones.shape[0]
    dist = lambda: (lambda p: (p / p.sum(-1, keepdims=True)).astype(np.float32))(
        rng.dirichlet(np.full(362, 0.3), n))
    score = rng.normal(0, 30, n).astype(np.float32)
    return dict(
        stones=states.stones.cpu().numpy(),
        last_moves=states.last_moves.cpu().numpy().astype(np.int16),
        color=states.to_move.cpu().numpy(), komi=np.full(n, 7.5, np.float32),
        pi=dist(), pi_aux=rng.integers(0, 362, n).astype(np.int16), pi_aux_dist=dist(),
        has_pi_aux_dist=rng.random(n) < 0.6,
        own=rng.integers(-1, 2, (n, 361)).astype(np.int8), score_margin=score,
        z=np.where(score > 0, 1.0, -1.0).astype(np.float32),
        **{k: np.tanh(rng.normal(0, 1, n)).astype(np.float32) for k in ("q6", "q16", "q50")},
        **{k: rng.normal(0, 10, n).astype(np.float32)
           for k in ("q6_score", "q16_score", "q50_score")},
        weight=np.ones(n, np.float32),
        mcts_value_dist=rng.integers(0, 20, (n, 51)).astype(np.uint16))


def test_scoring_on_card_equals_cpu(boards):
    """Benson scoring (labels, V/A count matrices, the removal loop) on the
    card: scores and ownership equal to the CPU's."""
    sub = map_state(lambda t: t[:256], boards)
    got = final_scores(sub)
    want = final_scores(map_state(lambda t: t.cpu(), sub))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert torch.equal(compute_pass_alive(sub).cpu(),
                       compute_pass_alive(map_state(lambda t: t.cpu(), sub)))


def test_prepare_batch_on_card_equals_cpu(boards, device):
    rows = _replay_rows(map_state(lambda t: t[:256], boards), 1)
    syms = torch.arange(256) % 8
    before = tl.point_liberties_batch.launches
    card = prepare_batch(rows, syms=syms.to(device), device=device)
    assert tl.point_liberties_batch.launches > before
    cpu = prepare_batch(rows, syms=syms, device="cpu")
    assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])
    for f in cpu[2]._fields:
        assert torch.equal(getattr(card[2], f).cpu(), getattr(cpu[2], f)), f


def test_float32_train_step_on_card_matches_cpu(boards, device):
    """One float32 sgd_nesterov step of b8c64 (train-mode BN, autograd,
    clipping) on the card and on the CPU: losses, grad_norm, parameter
    updates and BN statistics to rtol 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = _replay_rows(map_state(lambda t: t[:64], boards), 2)
    syms = torch.arange(64) % 8
    out = {}
    for dev in (device, torch.device("cpu")):
        m = seeded_model("b8c64", dev, torch.Generator().manual_seed(9))
        before = {k: v.detach().clone() for k, v in m.state_dict().items()}
        tx = sgd_nesterov(1e-2)
        state = create_train_state(m, tx)
        planes, scalars, targets = prepare_batch(rows, syms=syms.to(dev), device=dev)
        state, losses = make_train_step(m, tx, LossCoeffs.rl())(state, planes, scalars, targets)
        out[dev.type] = ({k: float(v) for k, v in losses.items()},
                         {k: (v - before[k]).cpu() for k, v in m.state_dict().items()})
    (l_card, d_card), (l_cpu, d_cpu) = out["cuda"], out["cpu"]
    for k in l_cpu:
        assert l_card[k] == pytest.approx(l_cpu[k], rel=1e-3, abs=1e-6), k
    for k in d_cpu:
        torch.testing.assert_close(d_card[k], d_cpu[k], rtol=1e-3, atol=1e-6, msg=k)


def test_from_stones_on_card_equals_cpu(boards):
    sub = map_state(lambda t: t[:128], boards)
    card = from_stones(sub.stones, sub.komi, sub.to_move, device=sub.stones.device)
    cpu = from_stones(sub.stones.cpu(), sub.komi.cpu(), sub.to_move.cpu(), device="cpu")
    for f in card._fields:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert torch.equal(card.chain_id, sub.chain_id)


def test_reset_finished_with_restarts_on_card_equals_cpu(boards, device):
    """reset_finished with restart states, per-board komi, no_raw and
    force_sel, the same uniforms on both devices."""
    B = 64
    gen = torch.Generator().manual_seed(2)
    sub = map_state(lambda t: t[:B], boards)
    init = from_stones(boards.stones[B:2 * B], boards.komi[B:2 * B], 1, device=device)._replace(
        move_count=torch.randint(0, 200, (B,), generator=gen, dtype=torch.int32).to(device))
    masks = [torch.rand(B, generator=gen).to(device) < p for p in (0.7, 0.6, 0.4, 0.4)]
    uniform = torch.rand(B, generator=gen).to(device)
    komi = torch.rand(B, generator=gen).to(device) * 20
    out = {}
    for dev in (device, torch.device("cpu")):
        mv = lambda t: t.to(dev)
        buf = make_game_buffer(B, 12, dev)
        buf.move.fill_(3)
        aux = make_aux(B, raw_until=torch.full((B,), 5), device=dev)
        done, use, no_raw, force = map(mv, masks)
        out[dev.type] = reset_finished(
            map_state(mv, sub), buf, aux, done, mv(komi), max_raw_policy_moves=30,
            reuse_tree=make_tree(B, 6, dev), uniform=mv(uniform), init_states=map_state(mv, init),
            use_init=use, no_raw=no_raw, force_sel=force)
    for part, a, b in zip(("state", "buf", "aux", "tree"), out["cuda"], out["cpu"]):
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f"{part}.{f}"


def test_fork_evaluator_on_card_equals_cpu(boards, device):
    """ForkEvaluator.evaluate / play with the same b8c64 weights on the card
    and on the CPU: legality and moved positions exact, network outputs
    to 1e-3 (float32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stones = boards.stones[:40].cpu().numpy()
    rng = np.random.default_rng(0)
    positions = [_Position(stones=s, last_moves=rng.integers(-1, 361, 5).astype(np.int32),
                           to_move=int(rng.choice([1, -1])), komi=7.5) for s in stones]
    out = {}
    for dev in (device, torch.device("cpu")):
        m = seeded_model("b8c64", dev, torch.Generator().manual_seed(3))
        ev = ForkEvaluator(batch=16, device=dev)
        legal, probs, value, score = ev.evaluate(m, positions)
        moves = [int(rng.choice(np.flatnonzero(l))) for l in legal] if dev == device \
            else out["moves"]
        out["moves"] = moves
        out[dev.type] = (legal, probs, value, score, ev.play(positions, moves))
    (lc, pc, vc, sc, playc), (l0, p0, v0, s0, play0) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(lc, l0)
    for a, b in ((pc, p0), (vc, v0), (sc, s0)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    for a, b in zip(playc, play0):
        np.testing.assert_array_equal(a.stones, b.stones)
        assert a.to_move == b.to_move


def test_generation_loop_on_card_runs_and_resumes(device, tmp_path):
    """One generation of the tiny configuration on the card, then a second
    loop resumes it bitwise."""
    cfg = RunConfig(model_config="tiny", num_generations=1, games_first_gen=4,
                    selfplay_batch_size=8, train_batch_size=16, selfplay_max_game_len=12,
                    eval_max_game_len=12, eval_games=4, eval_n=4, eval_k=2,
                    min_train_selected_n=4, max_train_selected_n=4, min_train_selected_k=2,
                    max_train_selected_k=2, min_train_default_n=4, max_train_default_n=4,
                    min_train_default_k=2, max_train_default_k=2, bn_recompute_passes=1,
                    val_batches=1, replay_capacity=1 << 12, use_seen_state_prob=0.25)
    loop = GenerationLoop(cfg, root_dir=str(tmp_path), device=device)
    before = tl.point_liberties_batch.launches
    assert loop.run_generation()["gen"] == 1
    assert tl.point_liberties_batch.launches > before
    again = GenerationLoop(cfg, root_dir=str(tmp_path), device=device)
    assert again.try_resume() and again.gen == 1
    for a, b in ((again.golden.state_dict(), loop.golden.state_dict()),
                 (again.train_state.params, loop.train_state.params)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert torch.equal(again.generator.get_state(), loop.generator.get_state())


def test_mcgs_insert_collisions_on_card_equal_cpu(device):
    """Colliding MCGS inserts keep the last lane on the card as on the CPU,
    twice in a row (scatter_last does not depend on the write order)."""
    from p3achygo_tpu_torch.mcts.tree import make_mcgs_table, mcgs_insert, mcgs_probe

    gen = torch.Generator().manual_seed(0)
    B, S, k_r = 64, 64, 16
    W = B * k_r
    # Few distinct keys, all >= 2**31: lanes of a board share slots.
    keys = torch.randint(1 << 31, 1 << 32, (8, 2), generator=gen, dtype=torch.int64)
    pick = torch.randint(0, 8, (W,), generator=gen)
    h0, h1 = keys[pick, 0], keys[pick, 1]
    meta = torch.ones(W, dtype=torch.int8)
    node = torch.arange(W, dtype=torch.int32)
    do = torch.rand(W, generator=gen) < 0.9
    tables = []
    for dev in ("cpu", device, device):
        tab = make_mcgs_table(B, S, dev)
        args = [t.to(dev) for t in (h0, h1, meta)]
        for _ in range(2):
            _, _, slot, has = mcgs_probe(tab, k_r, *args)
            mcgs_insert(tab, k_r, slot, *args, node.to(dev), do.to(dev) & has)
        tables.append([t.cpu() for t in tab])
    for got in tables[1:]:
        for a, b in zip(tables[0], got):
            assert torch.equal(a, b)


def test_bias_keys_on_card_equal_cpu(boards):
    """The bias keys of one leaf batch: liberties from the kernel on the
    card, the plain version on the CPU."""
    from p3achygo_tpu_torch.mcts.bias import local_pattern_keys

    out = []
    for st in (boards, map_state(lambda t: t.cpu(), boards)):
        libs = tl.point_liberties_batch(st.stones, st.chain_id)
        ill = (st.stones == 0) & ~legal_mask_batch(st)[:, :361]
        out.append([t.cpu() for t in local_pattern_keys(st.stones, libs == 1, ill,
                                                        st.last_moves, st.to_move)])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert bool(out[0][2].any())


def test_bias_branch_launches_the_liberty_kernel(device, boards):
    """A search with the bias branch on the card launches the CUDA liberty
    kernel for its leaves' pattern keys (besides legality and features),
    and its table fills."""
    from p3achygo_tpu_torch.mcts import gumbel as tg
    from p3achygo_tpu_torch.mcts.bias import make_bias_table

    st = map_state(lambda t: t[:8], boards)
    params = tg.SearchParams(n=8, k=2, max_depth=6)
    gen = torch.Generator(device=device).manual_seed(1)
    tl.point_liberties_batch.launches = 0
    tg.search_root(st, tg.uniform_eval_fn, params, generator=gen)
    plain = tl.point_liberties_batch.launches
    tl.point_liberties_batch.launches = 0
    _, table = tg.search_root(st, tg.uniform_eval_fn,
                              tg.SearchParams(n=8, k=2, max_depth=6, bias_lambda=0.35),
                              generator=gen, bias_table=make_bias_table(8, 64, device))
    torch.cuda.synchronize()
    assert tl.point_liberties_batch.launches > plain > 0
    assert int(table.used.sum()) > 0


def test_full_legal_mask_on_card_equals_cpu(boards):
    from p3achygo_tpu_torch.game.board import dry_run_status, full_legal_mask

    sub = map_state(lambda t: t[:8], boards)
    cpu = map_state(lambda t: t.cpu(), sub)
    assert torch.equal(full_legal_mask(sub).cpu(), full_legal_mask(cpu))
    act = torch.arange(8, device=sub.stones.device) * 45
    assert torch.equal(dry_run_status(sub, act).cpu(), dry_run_status(cpu, act.cpu()))


def test_laddered_stones_on_card_equal_cpu(boards):
    from p3achygo_tpu_torch.game.ladder import laddered_stones

    sub = map_state(lambda t: t[:256], boards)
    got = laddered_stones(sub)
    assert got.any()
    assert torch.equal(got.cpu(), laddered_stones(map_state(lambda t: t.cpu(), sub)))
    planes, _ = batched_features(sub, include_ladders=True)
    cpu_planes, _ = batched_features(map_state(lambda t: t.cpu(), sub), include_ladders=True)
    assert torch.equal(planes.cpu(), cpu_planes)


def test_gtp_genmove_launches_the_liberty_kernel(device):
    from p3achygo_tpu_torch.game.board import full_legal_mask
    from p3achygo_tpu_torch.gtp import GtpConfig, GtpService, gtp_vertex_to_action
    from p3achygo_tpu_torch.mcts.gumbel import SearchParams

    model = seeded_model("tiny", device, torch.Generator().manual_seed(0))
    svc = GtpService(make_eval_fn(model), GtpConfig(search=SearchParams(n=16, k=4)),
                     device=device)
    assert svc.handle("play b D4") == (True, "")
    before = tl.point_liberties_batch.launches
    ok, vertex = svc.handle("genmove w")
    assert ok and tl.point_liberties_batch.launches > before
    prev = svc._history[-1]  # the position genmove searched, white to move
    assert bool(full_legal_mask(prev)[0, gtp_vertex_to_action(vertex)])


def test_exporter_liberty_planes_on_card_equal_cpu(boards):
    """The chunk exporter's liberty planes: one kernel launch per game on
    the card, the plain version's integers on the CPU, the same records."""
    from p3achygo_tpu_torch.data.export import liberty_planes

    stones = boards.stones[:96].cpu().numpy()
    before = tl.point_liberties_batch.launches
    got = liberty_planes(stones, device=boards.stones.device)
    assert tl.point_liberties_batch.launches == before + 1
    np.testing.assert_array_equal(got, liberty_planes(stones, device="cpu"))
    assert ((got == 1) & (stones != 0)).any()


def test_actor_learner_round_trip_on_card(device, tmp_path):
    """One chunk over a local store bus at `tiny` on the card: the actor's
    chunk decodes to the games it sank, the learner ingests it once,
    trains, publishes gen 1, and the actor's hot-swapped golden equals the
    learner's bit for bit."""
    import dataclasses

    from p3achygo_tpu_torch.data.export import read_game_chunk
    from p3achygo_tpu_torch.data.store import make_store, most_recent_model
    from p3achygo_tpu_torch.rl.workers import Learner, SelfplayActor
    from p3achygo_tpu_torch.selfplay.records import GameExamples

    cfg = RunConfig(model_config="tiny", num_generations=1, games_per_gen=4,
                    selfplay_batch_size=8, train_batch_size=16, selfplay_max_game_len=12,
                    eval_max_game_len=12, eval_games=4, eval_n=4, eval_k=2,
                    min_train_selected_n=4, max_train_selected_n=4, min_train_selected_k=2,
                    max_train_selected_k=2, min_train_default_n=4, max_train_default_n=4,
                    min_train_default_k=2, max_train_default_k=2, bn_recompute_passes=1,
                    val_batches=1, val_game_frac=0.0, replay_capacity=1 << 12)
    store = make_store(str(tmp_path / "bus"))
    learner = Learner(cfg, store, run_dir=str(tmp_path / "learner"), device=device)
    learner.publish_golden()
    actor = SelfplayActor(cfg, store, scratch_dir=str(tmp_path / "actor"), seed=1,
                          device=device)
    assert actor.sync_model() and not actor.sync_model()
    sunk = []
    actor.loop.game_sink = lambda ex: (sunk.append(ex), actor._pending.append(ex))
    before = tl.point_liberties_batch.launches
    name = actor.play_and_publish(cfg.games_per_gen)
    assert tl.point_liberties_batch.launches > before
    back = read_game_chunk(store.local_path(name))
    for f in dataclasses.fields(GameExamples):
        want = np.concatenate([getattr(e, f.name) for e in sunk])
        if f.name == "weight":
            want = np.ones_like(want)
        np.testing.assert_array_equal(getattr(back, f.name), want, err_msg=f.name)
    assert learner.wait_for_examples(1, timeout_s=5.0) == len(back)
    assert learner.ingest_new_chunks() == 0
    assert learner.train_generation()["gen"] == 1 and most_recent_model(store) == 1
    assert actor.sync_model() and actor.loop.gen == 1
    want, have = learner.loop.golden.state_dict(), actor.loop.golden.state_dict()
    assert all(torch.equal(have[k], want[k]) for k in want)


def test_transformer_forward_on_card_matches_cpu(device, boards):
    """b14d96h3_transformer (14 blocks, embed 96, 3 heads) with seeded
    weights: float32 on the card (TF32 off) against float32 on the CPU on
    all 25 outputs to 1e-3; the bf16 forward finite, its value within 0.1
    of float32's. serve_fold falls back to this plain forward."""
    from p3achygo_tpu_torch.models.model import ModelOutputs
    from p3achygo_tpu_torch.nn.serve import serve_supported

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        m = seeded_model("b14d96h3_transformer", device, torch.Generator().manual_seed(7))
        m_cpu = seeded_model("b14d96h3_transformer", "cpu", torch.Generator().manual_seed(7))
        assert not serve_supported(m.config)
        planes, scalars = batched_features(map_state(lambda t: t[:64], boards),
                                           planes_dtype=torch.float32)
        card = m(planes, scalars)
        cpu = m_cpu(planes.cpu(), scalars.cpu())
        for f in ModelOutputs._fields:
            d = float((getattr(card, f).cpu() - getattr(cpu, f)).abs().max())
            assert d <= 1e-3, (f, d)
        m.dtype = torch.bfloat16
        b16 = m(planes, scalars)
        assert all(bool(torch.isfinite(getattr(b16, f)).all()) for f in ModelOutputs._fields)
        value = lambda o: (o.outcome_probs[:, 1] - o.outcome_probs[:, 0]).cpu()
        assert float((value(b16) - value(cpu)).abs().max()) <= 0.1
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def test_parallel_dry_run_one_nccl_rank(device):
    """`python -m p3achygo_tpu_torch.parallel --nproc 1` on the card: one
    NCCL rank passes the dry run's train-step and self-play parity checks."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "p3achygo_tpu_torch.parallel", "--nproc", "1"],
                         capture_output=True, text=True, timeout=300, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith('{"dryrun_multichip"'))
    summary = json.loads(line)["dryrun_multichip"]
    assert summary["backend"] == "nccl" and summary["n_devices"] == 1, summary


CONV_CASES = [(name, k, cin, cout, chain) for name, k, cin, cout, chain in SERVE_Q_SITES] + [
    (f"{cfg} {k}x{k} {cin}->{cout}", k, cin, cout, chain)
    for cfg, k, cin, cout, chain in SERVE_Q_WIDTHS]


@pytest.mark.parametrize("mode", EPILOGUE_MODES)
@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_conv_i8_equals_plain(device, case, N, mode):
    """The int32 sums and every output of each epilogue mode (the site's
    float32 chain-last or int8 in-chain, the residual with and without the
    next head, mish in bf16 and float32) equal the plain version's: the
    same operations in the same order."""
    name, k, cin, cout, chain = case
    gen = torch.Generator(device=device).manual_seed(N + cin)
    before = ci.conv_i8.launches
    args, kw = epilogue_case(k, cin, cout, N, chain, mode, device, gen)
    assert check_conv_i8(args, f"{name} {mode}", kw) == 0.0
    assert ci.conv_i8.launches == before + 1


def test_conv_i8_both_modes_of_one_site(device):
    gen = torch.Generator(device=device).manual_seed(1)
    x8, w8, s_in, s_w, bias, s_next = conv_i8_case(3, 64, 64, 5, True, device, gen)
    q = ci.conv_i8(x8, w8, s_in, s_w, bias, s_next)
    y = ci.conv_i8(x8, w8, s_in, s_w, bias)
    torch.cuda.synchronize()
    assert q.dtype == torch.int8 and y.dtype == torch.float32
    assert torch.equal(q, ci.quantize(mish(y), s_next))


def test_conv_i8_launch_counts(device):
    """One launch counted per call, in the total and under its mode; none
    for an empty batch."""
    gen = torch.Generator(device=device).manual_seed(2)
    case = conv_i8_case(1, 64, 32, 3, True, device, gen)
    before = ci.conv_i8.launches
    for i in range(1, 4):
        ci.conv_i8(*case)
        assert ci.conv_i8.launches == before + i
    empty = (torch.zeros((0, 19, 19, 64), dtype=torch.int8, device=device),) + case[1:]
    assert ci.conv_i8(*empty).shape == (0, 19, 19, 32)
    assert ci.conv_i8.launches == before + 3
    for mode, name in (("res", "res"), ("res_last", "res"), ("mish_bf16", "mish"),
                       ("site", "f32")):
        args, kw = epilogue_case(1, 64, 32, 3, False, mode, device, gen)
        total, by_mode = ci.conv_i8.launches, dict(ci.conv_i8.mode_launches)
        ci.conv_i8(*args, **kw)
        assert ci.conv_i8.launches == total + 1
        assert ci.conv_i8.mode_launches[name] == by_mode[name] + 1
        empty = (torch.zeros((0, 19, 19, 64), dtype=torch.int8, device=device),) + args[1:]
        kw0 = {k: (v[:0] if k == "q_prev" else v) for k, v in kw.items()}
        ci.conv_i8(*empty, **kw0)
        assert ci.conv_i8.launches == total + 1
    torch.cuda.synchronize()


def test_conv_i8_rejects_what_it_cannot_run(device):
    """Non-contiguous input, widths the kernel does not take: the wrapper
    raises and launches nothing; it never falls back to the plain version."""
    gen = torch.Generator(device=device).manual_seed(3)
    x8, w8, s_in, s_w, bias, s_next = conv_i8_case(1, 64, 32, 2, True, device, gen)
    before = ci.conv_i8.launches
    wide = torch.cat([x8, x8], dim=3)[..., ::2]
    with pytest.raises(ValueError):
        ci.conv_i8(wide, w8, s_in, s_w, bias, s_next)
    big = conv_i8_case(3, 384, 384, 1, False, device, gen)
    with pytest.raises(ValueError, match="Cin=384"):
        ci.conv_i8(*big)
    odd = conv_i8_case(1, 64, 12, 1, False, device, gen)
    with pytest.raises(ValueError, match="Cout=12"):
        ci.conv_i8(*odd)
    args, kw = epilogue_case(1, 64, 32, 2, False, "res", device, gen)
    strided = dict(kw, q_prev=torch.cat([kw["q_prev"]] * 2, dim=3)[..., ::2])
    with pytest.raises(ValueError, match="contiguous"):
        ci.conv_i8(*args, **strided)
    with pytest.raises(ValueError, match="one epilogue"):
        ci.conv_i8(*args[:5], s_next, **kw)
    with pytest.raises(ValueError, match="go together"):
        ci.conv_i8(*args, **dict(kw, a0=None))
    with pytest.raises(ValueError, match="mish_dtype"):
        ci.conv_i8(*args, mish_dtype=torch.float16)
    big_res = epilogue_case(3, 384, 384, 1, False, "res", device, gen)
    with pytest.raises(ValueError, match="Cin=384"):
        ci.conv_i8(*big_res[0], **big_res[1])
    assert ci.conv_i8.launches == before


@pytest.fixture(scope="module")
def serve_q_net(device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = seeded_model("b8c64", device, torch.Generator().manual_seed(8))
    m.dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(8)
    states = calibration_boards(128, 60, device, gen)
    planes, scalars = batched_features(states, planes_dtype=torch.bfloat16)
    return m, states, planes, scalars, calibrate(m, planes, scalars)


def test_serve_q_native_equals_emulated_on_card(serve_q_net):
    m, _, planes, scalars, scales = serve_q_net
    net = ServeQNet(m)
    before = ci.conv_i8.launches
    nat, emu = net(planes, scalars, scales, True), net(planes, scalars, scales, False)
    torch.cuda.synchronize()
    assert ci.conv_i8.launches > before
    assert float((nat.pi_logits - emu.pi_logits).abs().max()) <= SERVE_Q_NATIVE_TOL
    assert bool(torch.isfinite(nat.pi_logits).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serve_q_calibration_on_card_agrees_with_cpu(serve_q_net, dtype):
    """Record mode runs float32 with TF32 off, so only summation orders
    differ; in bf16 the broadcast mix's product also rounds where its sums
    differ (chip_smoke.SERVE_Q_CALIB_* says how far that moves a scale)."""
    m, _, planes, scalars, _ = serve_q_net
    m = copy.deepcopy(m)
    m.dtype = dtype
    card = calibrate(m, planes, scalars)
    cpu = calibrate(copy.deepcopy(m).cpu(), planes.cpu(), scalars.cpu())
    bound = SERVE_Q_CALIB_RTOL if dtype == torch.float32 else SERVE_Q_CALIB_BF16_RTOL
    assert set(card) == set(cpu)
    for k, s in card.items():
        assert abs(float(s) - float(cpu[k])) <= bound * float(cpu[k]), k


def test_serve_q_on_card_agrees_with_cpu(serve_q_net):
    """The card's forward against the CPU's with the same scales. mish's
    exp differs in the last bit between the card and the CPU, which can
    move an int8 value across a rounding boundary, and a random network
    carries such a flip on: they agree on the policy's top-1 and the
    value."""
    m, _, planes, scalars, scales = serve_q_net
    m_cpu = copy.deepcopy(m).cpu()
    p_cpu, s_cpu = planes.cpu(), scalars.cpu()
    card = ServeQNet(m)(planes, scalars, scales)
    cpu = ServeQNet(m_cpu)(p_cpu, s_cpu, {k: v.cpu() for k, v in scales.items()})
    top1 = (card.pi_logits.argmax(-1).cpu() == cpu.pi_logits.argmax(-1)).float().mean()
    assert float(top1) >= 0.9, float(top1)
    value = lambda o: o.outcome_probs[:, 1] - o.outcome_probs[:, 0]
    assert float((value(card).cpu() - value(cpu)).abs().max()) < 0.1


def test_serve_q_eval_launches_its_kernels(serve_q_net, device):
    m, states, _, _, scales = serve_q_net
    sub = map_state(lambda t: t[:32], states)
    before = (ci.conv_i8.launches, tl.point_liberties_batch.launches)
    out = make_eval_fn(m, serve_q_scales=scales)(sub)
    torch.cuda.synchronize()
    assert ci.conv_i8.launches > before[0]
    assert tl.point_liberties_batch.launches > before[1]
    assert bool(torch.isfinite(out.log_priors).all())


def test_serve_q_fused_graph_equals_plain_graph(device):
    """b12c128btl3 in bf16: the fused graph (int8 stream between blocks,
    RES and MISH epilogues) against the same net through the float32
    stream and plain ops: the last int8 stream and pi_logits equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = seeded_model("b12c128btl3", device, torch.Generator().manual_seed(12))
    m.dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(12)
    states = calibration_boards(96, 60, device, gen)
    planes, scalars = batched_features(states, planes_dtype=torch.bfloat16)
    scales = calibrate(m, planes, scalars)
    net = ServeQNet(m)
    ci.reset_launches()
    fused = net(planes, scalars, scales)
    # 9 btl blocks and 3 broadcast blocks: 12 block ends, 3 conv_first.
    assert ci.conv_i8.mode_launches["res"] == 12 and ci.conv_i8.mode_launches["mish"] == 3
    assert ci.conv_i8.mode_launches["f32"] == 0
    plain = net(planes, scalars, scales, fused=False)
    torch.cuda.synchronize()
    assert torch.equal(net.stream(planes, scalars, scales),
                       net.stream(planes, scalars, scales, fused=False))
    assert torch.equal(fused.pi_logits, plain.pi_logits)
    assert bool(torch.isfinite(fused.pi_logits).all())


# ---- ops/preact.py: the pre-activation kernel against the eager ops ----

PREACT_C = [16, 32, 64, 128, 192, 256, 384]
PREACT_N = [1, 7, 512, 2880]
PREACT_AB = ["none", "f32", "dtype", "b"]  # mish alone; BatchNorm's; ServeNet's head; a bias
# Inputs besides uniform -40..40: the clamp at 20 and its neighbours, signed
# zeros, subnormals of both dtypes, infinities (-inf gives mish's NaN), and
# the far negative side, where x*n becomes tiny and then subnormal.
PREACT_SPECIAL = [0.0, -0.0, 20.0, 19.9, 20.1, -20.0, 40.0, -40.0, 1e-39, -1e-39, 3e-40,
                  -7e-41, 1e-38, float("inf"), float("-inf"), 1e-3, -1e-3, 88.0, -88.0,
                  -60.0, -70.0, -85.0, -95.0, -110.0, -150.0]


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _preact_case(device, N, C, dtype, layout, ab, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed + 131 * C + N)
    x = torch.rand(N, C, 19, 19, generator=gen, device=device) * 80.0 - 40.0
    flat = x.view(-1)
    special = torch.tensor(PREACT_SPECIAL, device=device)
    idx = torch.arange(0, flat.numel(), 37, device=device)
    flat[idx] = special[torch.arange(idx.numel(), device=device) % special.numel()]
    x = x.to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    a = 0.25 + 1.5 * torch.rand(C, generator=gen, device=device)
    b = torch.rand(C, generator=gen, device=device) - 0.5
    a, b = {"none": (None, None), "f32": (a, b), "dtype": (a.to(dtype), b.to(dtype)),
            "b": (None, b.to(dtype))}[ab]
    return x, a, b


@pytest.mark.parametrize("ab", PREACT_AB)
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("N", PREACT_N)
@pytest.mark.parametrize("C", PREACT_C)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_preact_kernel_is_bit_equal_to_the_eager_ops(device, dtype, C, N, layout, ab):
    x, a, b = _preact_case(device, N, C, dtype, layout, ab)
    before = pa.preact.launches
    got = pa.preact(x, a, b)
    want = pa.preact_reference(x, a, b)
    torch.cuda.synchronize()
    assert pa.preact.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.stride() == want.stride()
    differ = _bits(got) != _bits(want)
    assert int(differ.sum()) == 0, (
        f"{int(differ.sum())} values differ, e.g. x {x[differ][:4].tolist()}: kernel "
        f"{got[differ][:4].tolist()}, eager {want[differ][:4].tolist()}")


@pytest.mark.parametrize("ab", PREACT_AB)
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_preact_kernel_is_bit_equal_on_every_bf16_and_random_float32_bits(device, dtype,
                                                                          layout, ab):
    """x takes every bf16 bit pattern (NaNs included), or 2^22 random
    float32 bit patterns, over [N, 16, 19, 19]."""
    x, a, b = _preact_case(device, 727, 16, dtype, layout, ab, seed=2)
    n = 1 << (16 if dtype == torch.bfloat16 else 22)
    gen = torch.Generator(device=device).manual_seed(4)
    bits = (torch.arange(n, device=device, dtype=torch.int32) if dtype == torch.bfloat16 else
            torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen, device=device,
                          dtype=torch.int64))
    flat = torch.zeros(x.numel(), dtype=dtype, device=device)
    flat[:n] = bits.to(_bits(flat).dtype).view(dtype)
    x = flat.view(727, 16, 19, 19)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    got, want = pa.preact(x, a, b), pa.preact_reference(x, a, b)
    differ = _bits(got) != _bits(want)
    assert int(differ.sum()) == 0, (
        f"{int(differ.sum())} values differ, e.g. x {_bits(x)[differ][:4].tolist()}: kernel "
        f"{_bits(got)[differ][:4].tolist()}, eager {_bits(want)[differ][:4].tolist()}")


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_preact_kernel_is_deterministic_and_counts_launches(device, layout):
    x, a, b = _preact_case(device, 512, 128, torch.bfloat16, layout, "f32", seed=1)
    before = pa.preact.launches
    first, second = pa.preact(x, a, b), pa.preact(x, a, b)
    torch.cuda.synchronize()
    assert pa.preact.launches == before + 2
    assert torch.equal(_bits(first), _bits(second))
    empty = pa.preact(x[:0], a, b)
    assert empty.shape == (0, 128, 19, 19) and pa.preact.launches == before + 2


def test_preact_rejects_what_the_kernel_cannot_run(device):
    x, a, b = _preact_case(device, 7, 16, torch.bfloat16, "nchw", "f32")
    with pytest.raises(TypeError):
        pa.preact(x.half(), a, b)
    with pytest.raises(ValueError):  # not 16-byte aligned
        pa.preact(x.reshape(-1)[1:1 + 16 * 361].reshape(1, 16, 19, 19), a, b)
    with pytest.raises(ValueError):
        pa.preact(x, a.cpu(), b)
    with torch.no_grad():
        assert not pa.engages(x.half()) and pa.engages(x)
        # Where the kernel engages, an activation it cannot take raises: the
        # call sites never drop back to the eager ops on the card.
        before = pa.preact.launches, pa.preact.plain_calls
        with pytest.raises(ValueError):  # neither layout
            pa.mish_affine(x.transpose(2, 3), a, b)
        with pytest.raises(ValueError):  # C not a multiple of 8
            pa.mish_affine(x[:, :12].contiguous(), a[:12], b[:12])
        w = torch.zeros(12, 16, 1, 1, dtype=x.dtype, device=device)
        with pytest.raises(ValueError):
            pa.conv_mish(x, w, b[:12].to(x.dtype), 0)
        assert (pa.preact.launches, pa.preact.plain_calls) == before
    assert not pa.engages(x)  # a gradient would be recorded


def _outputs_bits(out):
    return {k: _bits(v) for k, v in out._asdict().items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("B", [1, 7, 1024])
@pytest.mark.parametrize("name", ["b12c128btl3", "b14c384btl3"])
def test_forwards_with_the_preact_kernel_equal_the_eager_ops(device, boards, monkeypatch,
                                                             name, B):
    """The plain model and ServeNet in bf16, with the kernel and with the
    dispatch held to the eager ops (the route before the kernel: ServeNet's
    convolutions add their bias themselves), are bit-equal on the same
    boards, and the kernel runs once a ConvBlock and once a broadcast mix."""
    m = seeded_model(name, device, torch.Generator().manual_seed(19), dtype=torch.bfloat16)
    planes, scalars = batched_features(map_state(lambda t: t[:B], boards),
                                       planes_dtype=torch.bfloat16)
    blocks_ = [getattr(m, block_name(m.config, i)) for i in range(m.config.blocks)]
    per_forward = sum(isinstance(mod, (ConvBlock, Broadcast))
                      for blk in blocks_ for mod in blk.modules())
    net = ServeNet(m)
    runs = {}
    for mode in ("kernel", "eager"):
        if mode == "eager":
            monkeypatch.setattr(pa, "engages", lambda x: False)
        before = pa.preact.launches
        runs[mode] = (_outputs_bits(m(planes, scalars)), _outputs_bits(net(planes, scalars)))
        torch.cuda.synchronize()
        assert pa.preact.launches - before == (2 * per_forward if mode == "kernel" else 0)
    for got, want in zip(runs["kernel"], runs["eager"]):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
