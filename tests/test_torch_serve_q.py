"""The int8-activation serving graph of the PyTorch port (nn/serve_q.py,
ops/conv_i8.py) held against the JAX package's (p3achygo_tpu/nn/serve_q.py)
on the CPU, inputs made with numpy, weights carried by the bridge with
perturbed BN (`torch_parity.numpy_vars`).

The JAX side runs eagerly (op by op), as its own tests of these units run:
a jitted XLA program may fuse a division into a product with a reciprocal.

Tolerances and why:
* The integer units (`_quant_w`, `_quant_a`, the s32 sums, the
  dequantize-and-bias epilogue) are exact: the same IEEE operations on the
  same inputs.
* The requantizing epilogue computes mish, whose `exp` is XLA's polynomial
  on one side and PyTorch's on the other; they differ in the last bit for
  many inputs, and a value that sits on a rounding boundary then rounds to
  the other integer. So int8 outputs may differ by 1, on at most
  `FLIP_MAX` of the elements.
* Such a flip, once made, spreads through every later convolution of a
  network with random weights (for b8c64 far enough to move the policy
  logits past 1e-2 of their largest). So the whole-forward tests replay
  the JAX package's int8 values into the port at every quantization site
  (`_forced`): each site's float input must agree with JAX's to
  `SITE_TOL` relative to its largest value, each site's int8 output may differ from JAX's by 1 on at most
  `FLIP_MAX` of its elements, and the outputs, computed from the same int8
  streams, must agree to `PI_TOL` * max |pi| (policy logits) and
  `PROB_ATOL` (outcome and score probabilities), and top-1 on every board
  whose JAX top-two gap exceeds the policy bound. bf16 rounds the broadcast
  mix and the heads at the same points as JAX, but their float32 sums in
  another order, hence the wider bf16 bounds.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.mcts import gumbel as jg
from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.models.config import ModelConfig as JaxConfig
from p3achygo_tpu.nn import serve_q as jq
from p3achygo_tpu_torch.bridge import load_flax_variables, scales_from_jax, state_dict_to_flax
from p3achygo_tpu_torch.mcts import gumbel as tg
from p3achygo_tpu_torch.models.blocks import mish
from p3achygo_tpu_torch.models.config import ModelConfig, get_config
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.nn import serve_q as tq
from p3achygo_tpu_torch.nn.serve import ServeNet
from p3achygo_tpu_torch.ops import conv_i8 as tci
from torch_parity import numpy_vars, random_jax_states, state_to_torch

torch.set_num_threads(2)

FLIP_MAX = 1e-3
SITE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
PI_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
PROB_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
_SMALL = dict(blocks=4, broadcast_interval=3, channels=16, bottleneck_channels=8,
              head_channels=8, c_val=16)
CONFIGS = {"tiny": (jax_get_config("tiny"), get_config("tiny")),
           "b8c64": (jax_get_config("b8c64"), get_config("b8c64")),
           "classic": (JaxConfig(**_SMALL, trunk_block_type="classic"),
                       ModelConfig(**_SMALL, trunk_block_type="classic")),
           "nbt": (JaxConfig(**_SMALL, trunk_block_type="nbt"),
                   ModelConfig(**_SMALL, trunk_block_type="nbt"))}
_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _pair(name: str, dtype=torch.float32, seed: int = 0):
    """(flax model, its variables, the port's model) with the port's seeded
    init carried to flax and the BN statistics and affines perturbed."""
    jcfg, tcfg = CONFIGS[name]
    tm = build_model(tcfg, dtype, device="cpu")
    init_params(tm, torch.Generator().manual_seed(seed))
    v = numpy_vars(state_dict_to_flax(tm.state_dict()), np.random.default_rng(seed + 1))
    load_flax_variables(tm, v)
    return (jax_build(jcfg, dtype=_JAX_DTYPE[dtype]),
            jax.tree_util.tree_map(jnp.asarray, v), tm)


def _inputs(B: int, seed: int):
    rng = np.random.default_rng(seed)
    planes = (rng.random((B, 19, 19, 15)) < 0.3).astype(np.float32)
    scalars = rng.normal(size=(B, 8)).astype(np.float32)
    return planes, scalars


@functools.lru_cache(maxsize=None)
def _jax_calibration(name: str, dtype, residual_int8: bool):
    jm, v, _ = _pair(name, dtype)
    planes, scalars = _inputs(8, 3)
    return jq.calibrate(jm, v, jnp.asarray(planes), jnp.asarray(scalars),
                        residual_int8=residual_int8)


@contextlib.contextmanager
def _recorded():
    """Record every JAX `_quant_a` call: (float input, int8 output)."""
    rec, real = [], jq._quant_a

    def spy(x, s):
        r = real(x, s)
        rec.append((np.asarray(x, np.float32), np.asarray(r)))
        return r
    jq._quant_a = spy
    try:
        yield rec
    finally:
        jq._quant_a = real


@contextlib.contextmanager
def _forced(rec, dtype):
    """Replay `rec` into the port's quantizations, in call order, checking
    each site's float input and int8 output against JAX's; yields the
    per-site flip counts."""
    it, real, flips = iter(rec), tci.quantize, []

    def forced(x, s):
        r = real(x, s)
        jx, jr = next(it)
        xf = x.float().numpy()
        assert r.shape == jr.shape, (r.shape, jr.shape)
        dx = np.abs(xf - jx).max()
        assert dx <= SITE_TOL[dtype] * max(np.abs(jx).max(), 1e-6), (len(flips), dx)
        d = r.numpy().astype(np.int32) - jr.astype(np.int32)
        assert np.abs(d).max() <= 1, len(flips)
        flips.append(int((d != 0).sum()))
        assert flips[-1] <= FLIP_MAX * d.size, (len(flips), flips[-1], d.size)
        return torch.from_numpy(jr.copy())
    tci.quantize = tq.quantize = forced
    try:
        yield flips
        assert next(it, None) is None, "the port quantized fewer sites than JAX"
    finally:
        tci.quantize = tq.quantize = real


def _assert_outputs_close(got, want, dtype, fields=("outcome_probs", "score_probs")):
    pi_j = np.asarray(want.pi_logits, np.float32)
    pi_t = got.pi_logits.float().numpy()
    bound = PI_TOL[dtype] * np.abs(pi_j).max()
    assert np.abs(pi_t - pi_j).max() <= bound, np.abs(pi_t - pi_j).max() / np.abs(pi_j).max()
    top2 = np.sort(pi_j, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > bound
    np.testing.assert_array_equal(pi_t.argmax(1)[clear], pi_j.argmax(1)[clear])
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).float().numpy(),
                                   np.asarray(getattr(want, f), np.float32),
                                   rtol=0, atol=PROB_ATOL[dtype], err_msg=f)


# ---- (i) integer units, exact on identical inputs ----

@pytest.mark.parametrize("k", [1, 3])
def test_quant_w_matches_jax(k):
    rng = np.random.default_rng(k)
    w = rng.normal(0, 0.1, (k, k, 24, 16)).astype(np.float32)  # HWIO
    w[..., 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
    jw8, js = jq._quant_w(jnp.asarray(w))
    tw8, ts = tq._quant_w(torch.from_numpy(w).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(tw8.permute(2, 3, 1, 0).numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quant_a_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_t(3, (4, 19, 19, 8)) * 0.7).astype(np.float32)
    x[0, 0, 0, :4] = [0.5, 1.5, -2.5, 400.0]  # half-way cases and a clip
    s = np.float32(0.0137)
    got = tq._quant_a(torch.from_numpy(x), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._quant_a(jnp.asarray(x), s)))
    assert got.dtype == torch.int8


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("k,cin,cout", [(1, 128, 64), (3, 64, 64), (3, 128, 32)])
def test_conv_sums_match_jax(k, cin, cout):
    """conv_i8_acc (the plain version on the CPU) against JAX's _conv_i8,
    native and, where fan_in * 127^2 < 2^24 keeps float32 exact, emulated."""
    x8, w8 = _int8((2, 19, 19, cin), k), _int8((cout, k, k, cin), k + 1)
    got = tci.conv_i8_acc(torch.from_numpy(x8), torch.from_numpy(w8))
    assert got.dtype == torch.int32 and got.shape == (2, 19, 19, cout)
    w_hwio = jnp.asarray(w8.transpose(1, 2, 3, 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq._conv_i8(jnp.asarray(x8), w_hwio,
                                                                      True)))
    if k * k * cin * 127 * 127 < 2 ** 24:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jq._conv_i8(jnp.asarray(x8), w_hwio, False)))
        emulated = tq._conv_i8(torch.from_numpy(x8), torch.from_numpy(w8), native=False)
        assert torch.equal(emulated, got)


@pytest.mark.parametrize("in_chain", [False, True])
def test_fused_epilogue_matches_jax(in_chain):
    """conv_i8 against JAX's _chain_q step: _conv_i8, dequantize, bias, and
    in-chain mish and the next _quant_a. The float32 output is exact; the
    int8 one may flip at a rounding boundary (mish's exp)."""
    rng = np.random.default_rng(7)
    x8, w8 = _int8((4, 19, 19, 64), 8), _int8((64, 3, 3, 64), 9)
    s_in, s_next = np.float32(0.021), np.float32(0.043)
    s_w = rng.uniform(1e-4, 3e-4, 64).astype(np.float32)
    bias = rng.normal(0, 0.3, 64).astype(np.float32)
    y = jq._conv_i8(jnp.asarray(x8), jnp.asarray(w8.transpose(1, 2, 3, 0)), True)
    y = y.astype(jnp.float32) * (s_in * jnp.asarray(s_w)) + jnp.asarray(bias)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = tci.conv_i8(t(x8), t(w8), t(s_in), t(s_w), t(bias),
                      t(s_next) if in_chain else None)
    if not in_chain:
        np.testing.assert_array_equal(got.numpy(), np.asarray(y))
        return
    want = np.asarray(jq._quant_a(jq.mish(y), s_next)).astype(np.int32)
    d = got.numpy().astype(np.int32) - want
    assert got.dtype == torch.int8 and np.abs(d).max() <= 1
    assert (d != 0).sum() <= FLIP_MAX * d.size


def _boundary_case(cout: int, seed: int):
    """int32 sums and the scales, affines and previous stream of a block's
    last convolution, from numpy: sums near unit size after s_in * s_w."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-40000, 40000, (3, 19, 19, cout)).astype(np.int32)
    q_prev = _int8((3, 19, 19, cout), seed + 1)
    f = lambda *a: np.float32(rng.uniform(*a))
    return dict(acc=acc, s_in=f(0.01, 0.03), s_w=rng.uniform(1e-4, 3e-4, cout).astype(np.float32),
                q_prev=q_prev, s_prev=f(0.02, 0.04), s_res=f(0.03, 0.05),
                a0=rng.uniform(0.5, 1.5, cout).astype(np.float32),
                b0=rng.normal(0, 0.3, cout).astype(np.float32), s_head=f(0.02, 0.03))


BOUNDARY_MODES = ["res", "res_last", "mish_float32", "mish_bfloat16"]


def _epilogue_kwargs(mode: str, c: dict):
    t = lambda a: torch.from_numpy(np.asarray(a))
    if mode.startswith("mish"):
        return dict(mish_dtype=getattr(torch, mode[5:]))
    kw = dict(q_prev=t(c["q_prev"]), s_prev=t(c["s_prev"]), s_res=t(c["s_res"]))
    if mode == "res":
        kw.update(a0=t(c["a0"]), b0=t(c["b0"]), s_head=t(c["s_head"]))
    return kw


@pytest.mark.parametrize("mode", BOUNDARY_MODES)
def test_boundary_epilogues_equal_unfused_plain(mode):
    """The RES and MISH plain epilogues equal the unfused sequence the
    graph ran before them, bit for bit: the float32 chain-last output, then
    the residual add, requantize and next head (or mish, the cast and the
    permute to [N, C, 361])."""
    c = _boundary_case(32, 11)
    t = lambda a: torch.from_numpy(np.asarray(a))
    acc, s_in, s_w = t(c["acc"]), t(c["s_in"]), t(c["s_w"])
    got = tci.epilogue_reference(acc, s_in, s_w, **_epilogue_kwargs(mode, c))
    y = tci.epilogue_reference(acc, s_in, s_w)
    if mode.startswith("mish"):
        want = mish(y).to(getattr(torch, mode[5:]))
        assert torch.equal(got, want.permute(0, 3, 1, 2).reshape(3, 32, 361))
        return
    x = t(c["q_prev"]).float() * t(c["s_prev"]) + y
    q8 = tq._quant_a(x, t(c["s_res"]))
    assert torch.equal(got[0], q8)
    if mode == "res_last":
        assert got[1] is None
        return
    head = mish((q8.float() * t(c["s_res"])).float() * t(c["a0"]) + t(c["b0"]))
    assert torch.equal(got[1], tq._quant_a(head, t(c["s_head"])))


@pytest.mark.parametrize("mode", BOUNDARY_MODES)
def test_boundary_epilogues_match_jax(mode):
    """The RES epilogue against JAX's `requant_res` (x + d requantized at
    res{i}) and the next `_chain_q` head with its first `_quant_a`; MISH
    against `_broadcast_q`'s mish(u).astype(dtype). The requantized stream
    is exact (no mish on its way); the head's int8 and the bf16 mish may
    flip at a rounding boundary (mish's exp, see the module docstring)."""
    c = _boundary_case(32, 12)
    y = (jnp.asarray(c["acc"]).astype(jnp.float32) * (c["s_in"] * jnp.asarray(c["s_w"])))
    got = tci.epilogue_reference(*(torch.from_numpy(np.asarray(c[k]))
                                   for k in ("acc", "s_in", "s_w")),
                                 **_epilogue_kwargs(mode, c))
    if mode.startswith("mish"):
        want = np.asarray(jq.mish(y).astype(_JAX_DTYPE[getattr(torch, mode[5:])]), np.float32)
        want = want.transpose(0, 3, 1, 2).reshape(3, 32, 361)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-6 if mode.endswith(
            "float32") else 2 ** -8, atol=0)
        return
    x = jnp.asarray(c["q_prev"]).astype(jnp.float32) * c["s_prev"]
    q8 = jq._quant_a(x + y, c["s_res"])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(q8))
    if mode == "res_last":
        return
    xn = q8.astype(jnp.float32) * c["s_res"]
    u = jq.mish(xn * jnp.asarray(c["a0"]) + jnp.asarray(c["b0"]))
    d = got[1].numpy().astype(np.int32) - np.asarray(jq._quant_a(u, c["s_head"]), np.int32)
    assert np.abs(d).max() <= 1 and (d != 0).sum() <= FLIP_MAX * d.size


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_forward_equals_plain_graph(name):
    """The fused boundaries (RES, MISH) against the same net through the
    float32 stream and plain ops: the last int8 stream and every output
    equal, bit for bit."""
    _, _, tm = _pair(name)
    planes, scalars = (torch.from_numpy(a) for a in _inputs(2, 6))
    scales = tq.calibrate(tm, planes, scalars)
    net = tq.ServeQNet(tm)
    assert torch.equal(net.stream(planes, scalars, scales),
                       net.stream(planes, scalars, scales, fused=False))
    fused, plain = net(planes, scalars, scales), net(planes, scalars, scales, fused=False)
    for f in ("pi_logits", "outcome_probs", "score_probs", "q6_err"):
        assert torch.equal(getattr(fused, f), getattr(plain, f)), f


# ---- (ii) calibrate ----

@pytest.mark.parametrize("residual_int8", [True, False])
@pytest.mark.parametrize("name", ["tiny", "b8c64"])
def test_calibrate_matches_jax(name, residual_int8):
    _, _, tm = _pair(name)
    planes, scalars = _inputs(8, 3)
    got = tq.calibrate(tm, torch.from_numpy(planes), torch.from_numpy(scalars),
                       residual_int8=residual_int8)
    want = _jax_calibration(name, torch.float32, residual_int8)
    assert set(got) == set(want)
    for site, s in got.items():
        assert s.shape == () and s.dtype == torch.float32
        np.testing.assert_allclose(float(s), float(want[site]), rtol=1e-4, err_msg=site)


def test_percentile_matches_numpy():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 7, 11)).astype(np.float32))
    for q in (tq.CALIB_Q, 50.0, 100.0, 0.0):
        np.testing.assert_allclose(float(tq.percentile_abs(x, q)),
                                   np.percentile(np.abs(x.numpy()), q), rtol=1e-6)


# ---- (iii) the whole forward, JAX's scales carried across ----

FORWARD_CASES = [(name, torch.float32) for name in CONFIGS] + [("tiny", torch.bfloat16)]


@pytest.mark.parametrize("residual_int8", [True, False])
@pytest.mark.parametrize("name,dtype", FORWARD_CASES,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in FORWARD_CASES])
def test_forward_matches_jax(name, dtype, residual_int8):
    jm, v, tm = _pair(name, dtype)
    planes, scalars = _inputs(8, 5)
    js = _jax_calibration(name, dtype, residual_int8)
    with _recorded() as rec:
        want = jq.serve_q_forward(jm, v, jnp.asarray(planes), jnp.asarray(scalars),
                                  scales=js, native=False, residual_int8=residual_int8)
    net = tq.ServeQNet(tm)
    run = lambda native: net(torch.from_numpy(planes), torch.from_numpy(scalars),
                             scales_from_jax(js), native, residual_int8)
    for native in (True, False):
        with _forced(rec, dtype) as flips:
            got = run(native)
        _assert_outputs_close(got, want, dtype)
        assert len(flips) == len(rec)
    # Unforced, the exact integer sums make native and emulated bit-equal.
    nat, emu = run(True), run(False)
    for f in ("pi_logits", "outcome_probs", "score_probs", "q6_err"):
        assert torch.equal(getattr(nat, f), getattr(emu, f)), f


# ---- (iv) tests/test_serve_q.py's four, on the port ----

@pytest.mark.parametrize("name", ["tiny", "b8c64"])
def test_calibrate_scales(name):
    _, _, tm = _pair(name)
    planes, scalars = _inputs(8, 3)
    scales = tq.calibrate(tm, torch.from_numpy(planes), torch.from_numpy(scalars))
    assert len(scales) > 0
    for k, s in scales.items():
        assert s.shape == () and float(s) > 0, k


def _golden_b8c64():
    import os

    from p3achygo_tpu.train.checkpoint import restore_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tm = build_model(get_config("b8c64"), device="cpu")
    tmpl = state_dict_to_flax(tm.state_dict())
    restored = restore_checkpoint(os.path.join(root, "results", "curve-r4", "model_0016"),
                                  {**tmpl, "step": jnp.int32(0)})
    return load_flax_variables(tm, numpy_vars(restored))


@functools.lru_cache(maxsize=None)
def _randomized_b8c64():
    """b8c64 with the weights of tests/test_serve_q.py's own check: its
    JAX init and randomization (tests/test_serve_fold.py), bridged. The
    bounds are that check's, and they hold for some draws and not others:
    on a numpy draw of the same recipe the JAX graph and the port's alike
    miss the outcome bound."""
    from tests.test_serve_q import _net

    return load_flax_variables(build_model(get_config("b8c64"), device="cpu"),
                               numpy_vars(_net("b8c64")[1]))


@pytest.mark.parametrize("residual_int8", [True, False])
@pytest.mark.parametrize("weights", ["random", "golden"])
def test_quant_tracks_folded_graph(weights, residual_int8):
    tm = _randomized_b8c64() if weights == "random" else _golden_b8c64()
    planes, scalars = (torch.from_numpy(a) for a in _inputs(16, 5))
    scales = tq.calibrate(tm, planes, scalars, residual_int8=residual_int8)
    ref = ServeNet(tm)(planes, scalars)
    got = tq.serve_q_forward(tm, planes, scalars, scales=scales, native=False,
                             residual_int8=residual_int8)
    corr = np.corrcoef(ref.pi_logits.numpy().ravel(), got.pi_logits.numpy().ravel())[0, 1]
    assert corr > 0.99, corr
    np.testing.assert_allclose(got.outcome_probs.numpy(), ref.outcome_probs.numpy(), atol=0.06)
    np.testing.assert_allclose(got.score_probs.numpy(), ref.score_probs.numpy(), atol=0.05)


def test_native_matches_emulated():
    _, _, tm = _pair("tiny")
    planes, scalars = (torch.from_numpy(a) for a in _inputs(4, 9))
    scales = tq.calibrate(tm, planes, scalars)
    nat = tq.serve_q_forward(tm, planes, scalars, scales=scales, native=True)
    emu = tq.serve_q_forward(tm, planes, scalars, scales=scales, native=False)
    np.testing.assert_allclose(nat.pi_logits.numpy(), emu.pi_logits.numpy(), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "nbt", "classic"])
def test_kernel_inputs_are_contiguous(name, monkeypatch):
    """The card's kernel takes only contiguous tensors: every conv_i8 call
    of a forward gets them, the residual epilogue's q_prev, a0 and b0
    included (here the wrapper runs its plain version)."""
    _, _, tm = _pair(name)
    seen, res_args = [], []

    def spy(x8, w8, s_in, s_w, bias=None, s_next=None, **epilogue):
        ts = (x8, w8, s_w, bias, *(epilogue.get(k) for k in ("q_prev", "a0", "b0")))
        seen.append(all(t is None or t.is_contiguous() for t in ts))
        res_args.extend(k for k in ("q_prev", "a0", "b0") if epilogue.get(k) is not None)
        return tci.conv_i8(x8, w8, s_in, s_w, bias, s_next, **epilogue)
    monkeypatch.setattr(tq, "conv_i8", spy)
    planes, scalars = (torch.from_numpy(a) for a in _inputs(2, 4))
    tq.ServeQNet(tm)(planes, scalars, tq.calibrate(tm, planes, scalars))
    assert seen and all(seen)
    assert {"q_prev", "a0", "b0"} <= set(res_args)


def test_one_net_serves_any_calibration(monkeypatch):
    """Weights fold and quantize once, at construction; the scales are an
    argument (JAX's scales-as-traced-arguments test)."""
    _, _, tm = _pair("tiny")
    calls = []
    real = tq._quant_w
    monkeypatch.setattr(tq, "_quant_w", lambda w: calls.append(1) or real(w))
    net = tq.ServeQNet(tm)
    built = len(calls)
    planes, scalars = (torch.from_numpy(a) for a in _inputs(4, 1))
    s1 = tq.calibrate(tm, planes, scalars)
    s2 = {k: v * 1.5 for k, v in s1.items()}
    calls.clear()
    o1, o2 = net(planes, scalars, s1), net(planes, scalars, s2)
    assert built > 0 and not calls
    assert torch.isfinite(o1.pi_logits).all() and torch.isfinite(o2.pi_logits).all()
    assert not torch.allclose(o1.pi_logits, o2.pi_logits)


# ---- (v) make_eval_fn(serve_q_scales=) ----

@pytest.mark.parametrize("p_opt_weight", [0.0, 0.3])
def test_eval_fn_matches_jax(p_opt_weight):
    jm, v, tm = _pair("tiny")
    js = _jax_calibration("tiny", torch.float32, True)
    jstates = random_jax_states(B=6, moves=20, seed=4)
    j_eval = jg.make_eval_fn(jm, v, p_opt_weight=p_opt_weight, serve_q_scales=js)
    t_eval = tg.make_eval_fn(tm, p_opt_weight=p_opt_weight, serve_q_scales=scales_from_jax(js))
    with _recorded() as rec:
        want = j_eval(jstates)
    with _forced(rec, torch.float32):
        got = t_eval(state_to_torch(jstates))
    for f in ("log_priors", "outcome_value", "score_est", "score_var", "err_est"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_eval_fn_precedence(monkeypatch):
    """serve_q before serve_fold before the fused trunk (JAX gumbel.py:
    216-247); a transformer, which q_supported refuses, falls through to
    the plain forward."""
    built = []
    for name in ("ServeQNet", "ServeNet", "build_trunk_fn"):
        real = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _n=name, _r=real, **k: built.append(_n)
                            or _r(*a, **k))
    _, _, tm = _pair("tiny")
    scales = scales_from_jax(_jax_calibration("tiny", torch.float32, True))
    ts = state_to_torch(random_jax_states(B=2, moves=6, seed=1))
    out = tg.make_eval_fn(tm, serve_fold=True, use_fused_trunk=True, serve_q_scales=scales)(ts)
    assert built == ["ServeQNet"] and torch.isfinite(out.log_priors).all()

    built.clear()
    tr = build_model(get_config("b14d96h3_transformer"), device="cpu")
    init_params(tr, torch.Generator().manual_seed(0))
    got = tg.make_eval_fn(tr, serve_fold=True, serve_q_scales=scales)(ts)
    plain = tg.make_eval_fn(tr)(ts)
    assert built == []
    assert torch.equal(got.log_priors, plain.log_priors)


def test_selfplay_plies_with_serve_q():
    from p3achygo_tpu_torch.game.board import legal_mask_batch, new_state
    from p3achygo_tpu_torch.mcts.tree import make_tree
    from p3achygo_tpu_torch.selfplay.loop import (SelfplayConfig, make_aux, make_game_buffer,
                                                  selfplay_step_tiered)

    _, _, tm = _pair("tiny")
    scales = scales_from_jax(_jax_calibration("tiny", torch.float32, True))
    eval_fn = tg.make_eval_fn(tm, serve_q_scales=scales)
    B, gen = 8, torch.Generator().manual_seed(0)
    cfg = SelfplayConfig(batch_size=B)
    sel = tg.SearchParams(n=8, k=4, max_depth=8)
    fast = tg.SearchParams(n=4, k=2, max_depth=8)
    states = new_state(B, cfg.komi, device="cpu")
    buf = make_game_buffer(B, cfg.max_game_len, "cpu")
    aux = make_aux(B, gen, device="cpu")
    tree = make_tree(B, 16, "cpu")
    b = torch.arange(B)
    for _ in range(3):
        prev = states
        legal = legal_mask_batch(prev)
        states, buf, aux, tree = selfplay_step_tiered(
            states, buf, aux, eval_fn, sel, fast, cfg, generator=gen, reuse_tree=tree,
            reuse_capacity=16)
        t = prev.move_count.long()
        move = buf.move[b, t].long()
        assert bool(legal[b, move].all())
        pi = buf.pi[b, t].float()
        assert torch.isfinite(pi).all()
        torch.testing.assert_close(pi.sum(-1), torch.ones(B), atol=1e-4, rtol=0)
    assert int(states.move_count.min()) == 3
