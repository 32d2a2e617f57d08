"""The pre-activation dispatch of ops/preact.py on the CPU.

`mish_affine` keeps the eager ops wherever the kernel does not engage: on
the CPU (every call here), under `train=True`, with gradients recorded, in
float16 and float64. With `engages` stubbed to say yes and the kernel's
wrapper replaced by a recorder, the model's calls show which of them would
launch it. The wrapper's plain version is the eager formula bit for
bit, and the wrapper refuses what the kernel cannot take. The kernel itself
is held against the eager ops in tests/test_torch_cuda.py.
"""
from __future__ import annotations

import pytest
import torch

from p3achygo_tpu_torch.models import blocks
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import block_name, build_model, init_params
from p3achygo_tpu_torch.nn.serve import ServeNet
from p3achygo_tpu_torch.ops import preact as pa

torch.set_num_threads(2)


def _x(n, c, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, c, 19, 19, generator=g) * 8.0).to(dtype)


def _affine(c, seed=1):
    g = torch.Generator().manual_seed(seed)
    return 0.5 + torch.rand(c, generator=g), torch.rand(c, generator=g) - 0.5


def _conv_block(c, seed=2):
    g = torch.Generator().manual_seed(seed)
    cb = blocks.ConvBlock(c, c, 3)
    with torch.no_grad():
        cb.Conv_0.weight.copy_(torch.randn(cb.Conv_0.weight.shape, generator=g) / (3 * c ** 0.5))
        cb.BatchNorm_0.weight.copy_(0.7 + 0.6 * torch.rand(c, generator=g))
        cb.BatchNorm_0.bias.copy_(0.2 * (torch.rand(c, generator=g) - 0.5))
        cb.BatchNorm_0.running_mean.copy_(0.3 * torch.randn(c, generator=g))
        cb.BatchNorm_0.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return cb


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.fixture
def on_card(monkeypatch):
    """The kernel engages on every tensor, and the kernel's wrapper is a
    recorder that runs the plain version; yields the recorded calls."""
    calls = []

    def recorder(x, a=None, b=None):
        calls.append((tuple(x.shape), x.dtype, a is not None, b is not None))
        return pa.preact_reference(x, a, b)

    monkeypatch.setattr(pa, "engages", lambda x: True)
    monkeypatch.setattr(pa, "preact", recorder)
    monkeypatch.setattr(recorder, "launches", 0, raising=False)
    monkeypatch.setattr(recorder, "plain_calls", 0, raising=False)
    yield calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("train", [False, True])
def test_conv_block_on_cpu_keeps_the_eager_ops(dtype, train):
    cb = _conv_block(16).to(dtype)
    x = _x(3, 16, dtype)
    before = pa.preact.launches, pa.preact.plain_calls
    with torch.no_grad():
        got = cb(x, train=train)
        bn = blocks.BatchNorm.forward(cb.BatchNorm_0, x, train)
        want = cb.Conv_0(pa.mish(bn))
    assert torch.equal(_bits(got), _bits(want))
    assert (pa.preact.launches, pa.preact.plain_calls) == before


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_dispatch_keeps_the_eager_ops_on_the_cpu(dtype, grad, channels_last):
    x = _x(2, 16, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    a, b = _affine(16)
    w = torch.randn(16, 16, 3, 3, generator=torch.Generator().manual_seed(3)).to(dtype)
    before = pa.preact.launches, pa.preact.plain_calls
    with torch.set_grad_enabled(grad):
        assert not pa.engages(x)
        got = pa.mish_affine(x, a, b)
        conv = pa.conv_mish(x, w, b.to(dtype), 1)
        want_conv = pa.mish(torch.nn.functional.conv2d(x, w, b.to(dtype), padding=1))
    assert torch.equal(_bits(got), _bits(pa.preact_reference(x, a, b)))
    assert torch.equal(_bits(conv), _bits(want_conv))
    assert (pa.preact.launches, pa.preact.plain_calls) == before


def test_train_mode_blocks_never_reach_the_kernel(on_card):
    cb = _conv_block(16)
    mix = blocks.Broadcast(361)
    x = _x(2, 16)
    with torch.no_grad():  # a BN refresh: train=True under no_grad
        cb(x, train=True)
        mix(x, train=True)
    assert on_card == [] and pa.preact.plain_calls == 0
    with torch.no_grad():
        cb(x)
        mix(x)
    assert on_card == [((2, 16, 19, 19), torch.float32, True, True),
                       ((2, 16, 19, 19), torch.float32, False, False)]


@pytest.mark.parametrize("name", ["tiny", "b8c128nbt", "b15c192_classic"])
def test_forwards_launch_once_per_conv_block_and_broadcast_mix(on_card, name):
    """The plain model and ServeNet run one pre-activation a ConvBlock of
    the trunk (ServeNet: a chain head, or a folded in-chain BN) and one a
    broadcast mix; the heads keep their eager mish."""
    cfg = get_config(name)
    model = build_model(cfg, torch.float32, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    trunk = [getattr(model, block_name(cfg, i)) for i in range(cfg.blocks)]
    want = sum(isinstance(m, (blocks.ConvBlock, blocks.Broadcast))
               for blk in trunk for m in blk.modules())
    board, game = _inputs(model)
    model(board, game)
    assert len(on_card) == want
    on_card.clear()
    ServeNet(model)(board, game)
    assert len(on_card) == want


def _inputs(model):
    g = torch.Generator().manual_seed(5)
    c_in = model.init_board_conv.weight.shape[1]
    g_in = model.init_game_layer.weight.shape[1]
    return (torch.rand(2, 19, 19, c_in, generator=g).round(),
            torch.rand(2, g_in, generator=g))


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("ab", ["both", "a", "b", "none", "ab_in_x_dtype"])
def test_plain_version_is_the_eager_formula(dtype, ab, channels_last):
    x = _x(3, 24, dtype)
    x.view(-1)[:6] = torch.tensor([0.0, -0.0, 20.0, 40.0, -40.0, 1e-39]).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    a, b = _affine(24)
    if ab == "ab_in_x_dtype":
        a, b = a.to(dtype), b.to(dtype)
    a = a if ab in ("both", "a", "ab_in_x_dtype") else None
    b = b if ab in ("both", "b", "ab_in_x_dtype") else None
    ch = lambda v: v.to(dtype)[None, :, None, None]
    y = x if a is None else x * ch(a)
    y = y if b is None else y + ch(b)
    u = torch.exp(torch.clamp(y, max=20.0))
    n = u * u + 2.0 * u
    want = y * n / (n + 2.0)
    got = pa.preact(x, a, b)
    assert got.stride() == x.stride()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(pa.preact_reference(x, a, b)), _bits(want))


def test_plain_version_is_batchnorm_then_mish():
    cb = _conv_block(16).to(torch.bfloat16)
    x = _x(2, 16, torch.bfloat16)
    with torch.no_grad():
        want = pa.mish(cb.BatchNorm_0(x))
        assert torch.equal(_bits(pa.preact(x, *cb.BatchNorm_0.affine())), _bits(want))


@pytest.mark.parametrize("bad,exc", [
    (lambda x, a, b: (x[0], a, b), ValueError),  # rank 3
    (lambda x, a, b: (x.reshape(2, 16, 361, 1), a, b), ValueError),  # not 19x19
    (lambda x, a, b: (x.transpose(2, 3), a, b), ValueError),  # neither layout
    (lambda x, a, b: (x[:, :12].contiguous(memory_format=torch.channels_last), a[:12],
                      b[:12]), ValueError),  # C not a multiple of 8
    (lambda x, a, b: (x[:, :12].contiguous(), a[:12], b[:12]), ValueError),
    (lambda x, a, b: (x, a[:15], b), ValueError),  # a not of length C
    (lambda x, a, b: (x, a, torch.cat([b, b])), ValueError),  # b not of length C
    (lambda x, a, b: (x, a[None], b), ValueError),  # a not 1-D
    (lambda x, a, b: (x, torch.stack([a, a], 1)[:, 0], b), ValueError),  # a strided
    (lambda x, a, b: (x, a.double(), b), TypeError),  # a neither float32 nor x's dtype
    (lambda x, a, b: (x.to(torch.int32), None, None), TypeError),  # not floating point
])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad, exc):
    x = _x(2, 16, torch.bfloat16)
    a, b = _affine(16)
    with pytest.raises(exc):
        pa.preact(*bad(x, a, b))
