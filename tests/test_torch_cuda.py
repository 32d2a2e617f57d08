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
from p3achygo_tpu_torch.game.board import from_stones, legal_mask_batch, map_state
from p3achygo_tpu_torch.game.scoring import compute_pass_alive
from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn
from p3achygo_tpu_torch.ops import liberties as tl
from p3achygo_tpu_torch.ops import trunk as tk
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.rl.config import RunConfig
from p3achygo_tpu_torch.rl.loop import GenerationLoop
from p3achygo_tpu_torch.selfplay.fork import ForkEvaluator, _Position
from p3achygo_tpu_torch.selfplay.loop import final_scores, make_aux, make_game_buffer, reset_finished
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
