"""The PyTorch port's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips where there is no card. The
file imports no JAX, so it also runs on a machine that has a card and nvcc
but no JAX (the repo's conftest imports JAX, hence `--noconftest`):

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import KERNEL_TOL, random_boards, rel_err, seeded_model
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import legal_mask_batch, map_state
from p3achygo_tpu_torch.game.scoring import compute_pass_alive
from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn
from p3achygo_tpu_torch.ops import liberties as tl
from p3achygo_tpu_torch.ops import trunk as tk
from p3achygo_tpu_torch.selfplay.loop import final_scores
from p3achygo_tpu_torch.train.optimizer import sgd_nesterov
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step

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


@pytest.fixture(scope="module")
def trunks(device):
    """{config: trunk_fn} with seeded random weights and perturbed BN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    return {name: build_trunk_fn(m.config, m) for name in ("b8c64", "b12c128btl3")
            for m in [seeded_model(name, device, gen)]}


@pytest.mark.parametrize("name", ["b8c64", "b12c128btl3"])
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


@pytest.mark.parametrize("name", ["b8c64", "b12c128btl3"])
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


def test_segment_launches_count_one_per_call(trunks, device):
    w = trunks["b12c128btl3"].segments[0].weights
    x = torch.zeros((5, 361, 128), dtype=torch.bfloat16, device=device)
    before = tk.trunk_segment.launches
    for i in range(1, 4):
        tk.trunk_segment(x, w)
        assert tk.trunk_segment.launches == before + i
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["b8c64", "b12c128btl3"])
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


def test_broadcast_launches_count_one_per_call(trunks, device):
    bc = next(s for s in trunks["b12c128btl3"].segments if s.kernel is tk.trunk_broadcast)
    x = torch.zeros((5, 361, 128), dtype=torch.bfloat16, device=device)
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


def test_trunk_unsupported_width_raises(device):
    """`tiny` (C=16, Cb=8) is a btl trunk the kernels do not take: the
    wrappers raise and nothing falls back to the plain version."""
    m = seeded_model("tiny", device, torch.Generator().manual_seed(0))
    fn = build_trunk_fn(m.config, m)
    before = (tk.trunk_segment.launches, tk.trunk_broadcast.launches)
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 19, 19, 16), device=device))
    with pytest.raises(ValueError):
        tk.trunk_broadcast(torch.zeros((2, 361, 16), dtype=torch.bfloat16,
                                       device=device), fn.segments[1].weights)
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
