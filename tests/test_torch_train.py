"""The port's learning modules held against the JAX package on the same
seeded numpy inputs, at the `tiny` config in float32 and batch 8:
prepare_batch (exact, with JAX's symmetries), compute_losses (each of the
18 entries, and the gradients that reach the outputs, so every
stop_gradient is where JAX has it), the train-mode forward and its new BN
statistics, one sgd_nesterov train step, conv_muon and sgd_nesterov
updates, LR schedules, SWA and the BN refresh, validation metrics, and the
checkpoint round trip."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from p3achygo_tpu.models import ModelOutputs as JaxOutputs
from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.models import losses as jlosses
from p3achygo_tpu.train import lr_schedule as jlr
from p3achygo_tpu.train import optimizer as jopt
from p3achygo_tpu.train import swa as jswa
from p3achygo_tpu.train import val as jval
from p3achygo_tpu.train.step import create_train_state as jax_create_train_state
from p3achygo_tpu.train.step import make_train_step as jax_make_train_step
from p3achygo_tpu_torch.bridge import load_flax_variables, state_dict_to_flax
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.models import losses as tlosses
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import ModelOutputs, build_model
from p3achygo_tpu_torch.train import checkpoint as tckpt
from p3achygo_tpu_torch.train import lr_schedule as tlr
from p3achygo_tpu_torch.train import optimizer as topt
from p3achygo_tpu_torch.train import swa as tswa
from p3achygo_tpu_torch.train import val as tval
from p3achygo_tpu_torch.train.step import batch_stats_of, create_train_state, make_train_step
from torch_parity import numpy_vars, random_jax_states

torch.set_num_threads(2)

N = 8
FLOAT_OUTPUTS = [f for f in ModelOutputs._fields]


def _replay_rows(seed: int):
    """N replay rows (ReplayBuffer.sample's dict) with realistic stones and
    every target kind, extremes included (score margins past +-400, zero
    value histograms, examples without an aux distribution)."""
    rng = np.random.default_rng(seed)
    stones = np.asarray(random_jax_states(N, 40, seed).stones)

    def dist(alpha):
        p = rng.dirichlet(np.full(362, alpha), N)
        p[p < 1e-3] = 0.0
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)

    mvd = rng.integers(0, 20, (N, 51)).astype(np.uint16)
    mvd[:2] = 0
    score = rng.normal(0, 30, N).astype(np.float32)
    score[:2] = [-512.5, 431.2]
    return dict(
        stones=stones,
        last_moves=rng.integers(-1, 362, (N, 5)).astype(np.int16),
        color=rng.choice([1, -1], N).astype(np.int8),
        # komi / 15 is exact for these: XLA compiles the JAX package's
        # `/ 15.0` as a product with the float32 reciprocal, the port divides.
        komi=rng.choice([7.5, -0.5, 0.5], N).astype(np.float32),
        pi=dist(0.3), pi_aux=rng.integers(0, 362, N).astype(np.int16),
        pi_aux_dist=dist(0.5), has_pi_aux_dist=rng.random(N) < 0.6,
        own=rng.integers(-1, 2, (N, 361)).astype(np.int8),
        score_margin=score, z=np.where(score > 0, 1.0, -1.0).astype(np.float32),
        **{k: np.tanh(rng.normal(0, 1, N)).astype(np.float32) for k in ("q6", "q16", "q50")},
        **{k: rng.normal(0, 10, N).astype(np.float32)
           for k in ("q6_score", "q16_score", "q50_score")},
        weight=np.ones(N, np.float32), mcts_value_dist=mvd)


def _jax_syms(key):
    """The symmetries JAX's prepare_batch draws from `key` (pipeline.py:77)."""
    _, ksym = jax.random.split(key)
    return np.asarray(jax.random.randint(ksym, (N,), 0, 8))


def _np(x):
    x = x.detach() if torch.is_tensor(x) else x
    return np.asarray(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x)


@pytest.fixture(scope="module")
def nets():
    """The tiny network in float32 on both sides, BN perturbed; flax
    variables as numpy."""
    jm = jax_build(jax_get_config("tiny"))
    variables = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(2), jnp.zeros((1, 19, 19, 15)), jnp.zeros((1, 8)), train=False)
    np_vars = numpy_vars(variables, np.random.default_rng(3))
    return jm, np_vars


def _port_model(np_vars):
    return load_flax_variables(build_model(get_config("tiny"), device="cpu"), np_vars)


@pytest.fixture(scope="module")
def batch():
    rows = _replay_rows(11)
    key = jax.random.PRNGKey(4)
    jp, js, jt = jax.jit(jax_prepare_batch)(key, {k: jnp.asarray(v) for k, v in rows.items()})
    return rows, key, (np.asarray(jp), np.asarray(js), jax.tree_util.tree_map(np.asarray, jt))


def _port_batch(batch):
    rows, key, _ = batch
    return prepare_batch(rows, syms=torch.tensor(_jax_syms(key)), device="cpu")


def test_prepare_batch_exact(batch):
    rows, key, (jp, js, jt) = batch
    planes, scalars, targets = _port_batch(batch)
    assert planes.dtype == torch.float32 and planes.shape == (N, 19, 19, 15)
    np.testing.assert_array_equal(planes.numpy(), jp)
    np.testing.assert_array_equal(scalars.numpy(), js)
    for f in jlosses.GroundTruth._fields:
        np.testing.assert_array_equal(_np(getattr(targets, f)), getattr(jt, f), err_msg=f)
    assert len(set(_jax_syms(key).tolist())) > 1


def test_prepare_batch_no_augment():
    rows = _replay_rows(12)
    jp, js, jt = jax.jit(functools.partial(jax_prepare_batch, augment=False))(
        None, {k: jnp.asarray(v) for k, v in rows.items()})
    planes, scalars, targets = prepare_batch(rows, augment=False, device="cpu")
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scalars.numpy(), np.asarray(js))
    for f in jlosses.GroundTruth._fields:
        np.testing.assert_array_equal(_np(getattr(targets, f)), np.asarray(getattr(jt, f)))


def _random_outputs(seed):
    """Model outputs of plausible ranges, as numpy."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    out = dict(pi_logits=2 * g(N, 362), outcome_logits=g(N, 2),
               ownership=np.tanh(g(N, 361)), score_logits=3 * g(N, 800),
               gamma=0.3 * g(N, 1), pi_logits_aux=2 * g(N, 362),
               q6=np.tanh(g(N)), q16=np.tanh(g(N)), q50=np.tanh(g(N)),
               q6_err=np.abs(g(N)), q16_err=np.abs(g(N)), q50_err=np.abs(g(N)),
               q6_score=5 * g(N), q16_score=5 * g(N), q50_score=5 * g(N),
               q6_score_err=np.abs(5 * g(N)), q16_score_err=np.abs(5 * g(N)),
               q50_score_err=np.abs(5 * g(N)),
               pi_logits_soft=g(N, 362), pi_logits_optimistic=g(N, 362),
               mcts_dist_logits=g(N, 51))
    sm = lambda x: np.exp(x - x.max(-1, keepdims=True)) / np.exp(
        x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)
    for p, l in (("pi_probs", "pi_logits"), ("outcome_probs", "outcome_logits"),
                 ("score_probs", "score_logits"), ("mcts_dist_probs", "mcts_dist_logits")):
        out[p] = sm(out[l]).astype(np.float32)
    return out


@pytest.mark.parametrize("coeffs", ["rl", "sl"])
def test_compute_losses_and_their_gradients(batch, coeffs):
    _, _, (_, _, jt) = batch
    outs = _random_outputs(5)
    jw, tw = getattr(jlosses.LossCoeffs, coeffs)(), getattr(tlosses.LossCoeffs, coeffs)()
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
    jt_j = jax.tree_util.tree_map(jnp.asarray, jt)

    def jax_total(o):
        losses = jlosses.compute_losses(JaxOutputs(**o), jt_j, jw)
        return losses["loss"], losses

    (_, jl), jgrad = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outs.items()})
    t_in = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    _, _, targets = _port_batch(batch)
    tl = tlosses.compute_losses(ModelOutputs(**t_in), targets, tw)
    assert set(tl) == set(jl) and len(tl) == 18
    for k in jl:
        np.testing.assert_allclose(tl[k].detach().numpy(), np.asarray(jl[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    tl["loss"].backward()
    for k, v in t_in.items():
        got = v.grad.numpy() if v.grad is not None else np.zeros_like(outs[k])
        np.testing.assert_allclose(got, np.asarray(jgrad[k]), rtol=1e-4, atol=1e-7, err_msg=k)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_close(got, want, rtol, atol, what):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {'/'.join(k)}")


def _f64(tree):
    """Floating leaves as float64 jnp arrays (call under jax.enable_x64)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64 if np.issubdtype(np.asarray(x).dtype, np.floating)
                              else np.asarray(x).dtype), tree)


# The train-mode forward and the train step are held against the JAX
# package run in float64 (jax.enable_x64), the port in float32. XLA:CPU's
# float32 reductions are sequential sums: at one train-mode BatchNorm of
# this batch its batch mean is 1.2e-6 off a float64 sum (the port's 8e-8),
# which the normalisation passes on to every output (~1e-4 at the logits),
# and the score head's gradient is a small difference of large sums, of
# which JAX's float32 backward keeps no digit (up to 180% off float64 here)
# while the port's float32 one agrees with float64 to 1e-6.


def test_train_forward_and_batch_stats(nets, batch):
    jm, np_vars = nets
    _, _, (jp, js, _) = batch
    with jax.enable_x64(True):
        jm64 = jax_build(jax_get_config("tiny"), dtype=jnp.float64)
        jout, mutated = jax.jit(functools.partial(jm64.apply, train=True,
                                                  mutable=["batch_stats"]))(
            _f64(np_vars), _f64(jp), _f64(js))
        jout = jax.tree_util.tree_map(np.asarray, jout)
        want_stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    tm = _port_model(np_vars)
    tout = tm(torch.tensor(jp), torch.tensor(js), train=True)
    assert tout.pi_logits.requires_grad
    for f in FLOAT_OUTPUTS:
        np.testing.assert_allclose(_np(getattr(tout, f)), getattr(jout, f),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    new_stats = state_dict_to_flax(tm.state_dict())["batch_stats"]
    _assert_trees_close(new_stats, want_stats, 1e-5, 1e-7, "batch_stats")
    # The inference forward leaves the statistics alone and builds no graph.
    before = {k: v.clone() for k, v in batch_stats_of(tm).items()}
    assert not tm(torch.tensor(jp), torch.tensor(js)).pi_logits.requires_grad
    assert all(torch.equal(before[k], v) for k, v in batch_stats_of(tm).items())


def test_sgd_nesterov_train_step(nets, batch):
    jm, np_vars = nets
    _, _, (jp, js, jt) = batch
    with jax.enable_x64(True):
        jm64 = jax_build(jax_get_config("tiny"), dtype=jnp.float64)
        tx = jopt.sgd_nesterov(1e-2)
        jstate = jax_create_train_state(_f64(np_vars), tx)
        jstep = jax.jit(jax_make_train_step(jm64, tx, jlosses.LossCoeffs.rl()))
        jstate, jl = jstep(jstate, _f64(jp), _f64(js), _f64(jt))
        jl = {k: float(v) for k, v in jl.items()}
        want = {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}

    tm = _port_model(np_vars)
    ttx = topt.sgd_nesterov(1e-2)
    tstate = create_train_state(tm, ttx)
    planes, scalars, targets = _port_batch(batch)
    tstate, tl = make_train_step(tm, ttx, tlosses.LossCoeffs.rl())(
        tstate, planes, scalars, targets)
    assert tstate.step == 1 and jl["grad_norm"] > 1.0  # the clip acted
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), jl[k], rtol=1e-4, atol=1e-6, err_msg=k)
    got = state_dict_to_flax(tm.state_dict())
    for part in ("params", "batch_stats"):
        _assert_trees_close(got[part], want[part], 1e-4, 1e-6, part)


def _grad_trees(np_vars, seed, scale):
    """Random gradients shaped like the tiny net's parameters: the flax
    tree for JAX and the port's dict."""
    rng = np.random.default_rng(seed)
    tm = _port_model(np_vars)
    tgrads = {k: torch.tensor(rng.normal(0, scale, p.shape).astype(np.float32))
              for k, p in tm.named_parameters()}
    jgrads = state_dict_to_flax(tgrads)["params"]
    return tm, tgrads, jax.tree_util.tree_map(jnp.asarray, jgrads)


@pytest.mark.parametrize("opt", ["sgd_small", "sgd_clipped", "conv_muon", "conv_muon_schedule"])
def test_optimizer_updates(nets, opt):
    """Two updates of each optimizer on the tiny net's parameter shapes:
    conv_muon's Muon leaves (convs and denses, flattened in the flax
    layout) and AdamW leaves, and both branches of the gradient clip."""
    _, np_vars = nets
    if opt.startswith("sgd"):
        jtx, ttx = jopt.sgd_nesterov(1e-2), topt.sgd_nesterov(1e-2)
    elif opt == "conv_muon":
        jtx, ttx = jopt.conv_muon(2e-2), topt.conv_muon(2e-2)
    else:
        jtx = jopt.conv_muon(jlr.cyclic_lr(1e-3, 1e-2, 4), wd_lr_max=1e-2)
        ttx = topt.conv_muon(tlr.cyclic_lr(1e-3, 1e-2, 4), wd_lr_max=1e-2)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_vars["params"])
    tm = _port_model(np_vars)
    tparams = dict(tm.named_parameters())
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    jupdate = jax.jit(jtx.update)
    for i in range(2):
        scale = 1e-4 if opt == "sgd_small" else 0.1
        _, tgrads, jgrads = _grad_trees(np_vars, 20 + i, scale)
        if opt.startswith("sgd"):
            assert (float(topt.global_norm(tgrads)) < 1.0) == (opt == "sgd_small")
        jupd, jstate = jupdate(jgrads, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, jupd)
        tupd, tstate = ttx.update(tgrads, tstate, tparams)
        topt.apply_updates(tparams, tupd)
        # atol 1e-6 against updates of up to 2e-2: Newton-Schulz's products
        # and Adam's second step round differently in the two frameworks.
        _assert_trees_close(state_dict_to_flax(tupd)["params"],
                            jax.tree_util.tree_map(np.asarray, jupd), 1e-4, 1e-6,
                            f"{opt} update {i}")
    _assert_trees_close(state_dict_to_flax(tm.state_dict())["params"],
                        jax.tree_util.tree_map(np.asarray, jparams), 1e-4, 1e-7, opt)
    if opt.startswith("conv_muon"):
        muon = [k for k, p in tparams.items() if topt._is_muon_leaf(
            topt.to_flax_layout(p, k).shape)]
        assert 0 < len(muon) < len(tparams)


def test_lr_schedules():
    pairs = [(jlr.constant_lr(3e-3), tlr.constant_lr(3e-3)),
             (jlr.cyclic_lr(1e-3, 1e-2, 10), tlr.cyclic_lr(1e-3, 1e-2, 10)),
             (jlr.cyclic_lr(1e-3, 1e-2, 7), tlr.cyclic_lr(1e-3, 1e-2, 7)),
             (jlr.cyclic_lr_decay(1e-3, 1e-2, 40), tlr.cyclic_lr_decay(1e-3, 1e-2, 40))]
    for jf, tf in pairs:
        for step in range(0, 60):
            np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))), rtol=1e-6)

    @dataclasses.dataclass
    class Cfg:
        lr: float = 0.01
        lr_growth_window: int = 5
        lr_schedule: tuple = ((10, 0.005), (20, 0.002))
        lr_transition_window: int = 4

    for cfg in (Cfg(), Cfg(lr_growth_window=0, lr_schedule=None, lr_transition_window=0)):
        for gen in range(25):
            assert tlr.lr_for_gen(cfg, gen) == jlr.lr_for_gen(cfg, gen)
    for gen in range(25):
        assert tlr.gen_growth_scale(gen) == jlr.gen_growth_scale(gen)


def test_swa_and_snapshots():
    rng = np.random.default_rng(6)
    steps = [{"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)} for _ in range(4)]
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    np.testing.assert_allclose(
        tswa.swa_average(t(steps[0]), t(steps[1]))["a"].numpy(),
        np.asarray(jswa.swa_average(steps[0], steps[1])["a"]), rtol=1e-6)
    jm, tm = jswa.SnapshotManager(interval=2), tswa.SnapshotManager(interval=2)
    live = t(steps[0])
    for i, s in enumerate(steps):
        jm.maybe_snapshot(i, s)
        for k in live:
            live[k].copy_(torch.tensor(s[k]))  # trained in place, as the port's params are
        tm.maybe_snapshot(i, live)
    for k in live:
        np.testing.assert_allclose(tm.final(live)[k].numpy(),
                                   np.asarray(jm.final(steps[-1])[k]), rtol=1e-6)


def test_recompute_batch_stats(nets):
    jm, np_vars = nets
    batches = []
    for seed in (31, 32, 33):
        rows = _replay_rows(seed)
        p, s, _ = prepare_batch(rows, augment=False, device="cpu")
        batches.append((p, s))
    want = jswa.recompute_batch_stats(
        jm, jax.tree_util.tree_map(jnp.asarray, np_vars["params"]),
        jax.tree_util.tree_map(jnp.asarray, np_vars["batch_stats"]),
        [(jnp.asarray(p.numpy()), jnp.asarray(s.numpy())) for p, s in batches],
        num_passes=2)
    tm = _port_model(np_vars)
    assert tswa.recompute_batch_stats(tm, batches, num_passes=2) == 2
    _assert_trees_close(state_dict_to_flax(tm.state_dict())["batch_stats"],
                        jax.tree_util.tree_map(np.asarray, want), 1e-5, 1e-7, "refresh")


def test_batch_metrics_and_validate(nets, batch):
    jm, np_vars = nets
    _, _, (jp, js, jt) = batch
    outs = _random_outputs(8)
    jmet = jval.batch_metrics(JaxOutputs(**{k: jnp.asarray(v) for k, v in outs.items()}),
                              jax.tree_util.tree_map(jnp.asarray, jt))
    _, _, targets = _port_batch(batch)
    tmet = tval.batch_metrics(ModelOutputs(**{k: torch.tensor(v) for k, v in outs.items()}),
                              targets)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    jv = jval.validate(jm, jax.tree_util.tree_map(jnp.asarray, np_vars),
                       [(jnp.asarray(jp), jnp.asarray(js),
                         jax.tree_util.tree_map(jnp.asarray, jt))] * 2,
                       jlosses.LossCoeffs.rl())
    tv = tval.validate(_port_model(np_vars), [_port_batch(batch)] * 2,
                       tlosses.LossCoeffs.rl())
    assert tv.keys() == jv.keys()
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_checkpoint_round_trip(nets, batch, tmp_path):
    _, np_vars = nets
    tm = _port_model(np_vars)
    tx = topt.sgd_nesterov(1e-2)
    state = create_train_state(tm, tx)
    state, _ = make_train_step(tm, tx, tlosses.LossCoeffs.rl())(state, *_port_batch(batch))
    root = str(tmp_path / "models")
    assert tckpt.latest_generation(root) is None
    tree = {"model": tm.state_dict(), "opt_state": state.opt_state, "step": state.step}
    for gen in (1, 3):
        path = tckpt.save_checkpoint(root, gen, tree)
    assert path.endswith(tckpt.MODEL_FMT % 3) and tckpt.latest_generation(root) == 3
    fresh = build_model(get_config("tiny"), device="cpu")
    got = tckpt.restore_checkpoint(path)
    fresh.load_state_dict(got["model"])
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert got["step"] == 1 and got["opt_state"]["count"] == 1
    for k, v in state.opt_state["trace"].items():
        assert torch.equal(got["opt_state"]["trace"][k], v), k
    live = tckpt.restore_checkpoint(str(tmp_path / "models" / tckpt.LIVE_NAME))
    assert all(torch.equal(live["model"][k], v) for k, v in tm.state_dict().items())
