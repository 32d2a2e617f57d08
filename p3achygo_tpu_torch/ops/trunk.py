"""Fused-trunk kernels: the hand-written CUDA kernels and their plain
PyTorch versions (counterparts of the Pallas kernels of p3achygo_tpu's
nn/trunk_kernel.py `_make_kernel` and nn/trunk_kernel2.py
`_make_segment_kernel`).

Two calls make a trunk of bottleneck and broadcast blocks, on activations
x [N, 361, C] bf16 (channels last, one row per board position):

* `trunk_segment` runs a run of consecutive bottleneck blocks in one
  launch of `csrc/trunk.cu` `p3_trunk_segment`;
* `trunk_broadcast` runs one broadcast block (`p3_trunk_broadcast`).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain version (`trunk_segment_reference`,
`trunk_broadcast_reference`), which rounds to bf16 at exactly the kernel's
points and does every product as a float32 product of bf16-rounded
operands (what the Pallas kernels' `preferred_element_type=f32` computes).
On the card the plain versions need TF32 off (`torch.backends.cudnn.
allow_tf32` and `torch.backends.cuda.matmul.allow_tf32`) to be float32.
Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.constants import NUM_LOCS
from p3achygo_tpu_torch.models.blocks import mish_f32
from p3achygo_tpu_torch.ops.cuda_build import load_library

SOURCE = "trunk.cu"
MIX_PAD = 368  # the broadcast kernel's position tiles: 23 x 16 rows
# Widths the kernels take: (channels, bottleneck) for a segment, channels
# for a broadcast block.
SEGMENT_WIDTHS = ((64, 32), (128, 64))
BROADCAST_WIDTHS = (64, 128)


class SegmentWeights(NamedTuple):
    """A run of `n_blocks` bottleneck blocks with `inner` 3x3 layers each."""

    aff: torch.Tensor  # f32 [n_blocks, 2 + inner, 2, C]: layer l's (a, b)
    #                    over its input channels (reduce C; inner, expand Cb)
    wr: torch.Tensor  # bf16 [n_blocks, C, Cb] 1x1 reduce, [Cin, Cout]
    w9: torch.Tensor  # bf16 [n_blocks, inner, 9 * Cb, Cb] 3x3 in OFFSETS order
    we: torch.Tensor  # bf16 [n_blocks, Cb, C] 1x1 expand


class BroadcastWeights(NamedTuple):
    """One broadcast block: conv_first, the position mix, conv_last."""

    f_aff: torch.Tensor  # f32 [2, C]
    wf: torch.Tensor  # bf16 [C, C]
    wdt: torch.Tensor  # bf16 [368, 368]: wdt[q, p] = Dense kernel[p, q], 0-padded
    bd: torch.Tensor  # f32 [361]
    l_aff: torch.Tensor  # f32 [2, C]
    wl: torch.Tensor  # bf16 [C, C]


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


def _check_x(x: torch.Tensor, channels: int) -> None:
    if x.dim() != 3 or x.shape[1] != NUM_LOCS or x.shape[2] != channels:
        raise ValueError(f"x must be [N, {NUM_LOCS}, {channels}], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no trunk kernel for device {x.device}")


def _check_weights(x: torch.Tensor, weights: NamedTuple) -> None:
    for name, t in zip(type(weights)._fields, weights):
        if t.device != x.device:
            raise ValueError(f"weight {name} on {t.device}, x on {x.device}")
        want = torch.float32 if name in ("aff", "f_aff", "l_aff", "bd") else torch.bfloat16
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
    fn = load_library(SOURCE).p3_trunk_segment
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _broadcast_kernel():
    fn = load_library(SOURCE).p3_trunk_broadcast
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    for name, want in shapes.items():
        if tuple(getattr(w, name).shape) != want:
            raise ValueError(f"weight {name} is {tuple(getattr(w, name).shape)}, want {want}")
    if n_blocks < 1:
        raise ValueError("a segment has at least one block")
    _check_x(x, C)
    _check_weights(x, w)
    if x.device.type == "cpu":
        return trunk_segment_reference(x, w)
    if (C, cb) not in SEGMENT_WIDTHS:
        raise ValueError(f"the segment kernel takes (channels, bottleneck) in "
                         f"{SEGMENT_WIDTHS}, not {(C, cb)}")
    _check_launchable(x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = _segment_kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), w.aff.data_ptr(), w.wr.data_ptr(),
                w.w9.data_ptr(), w.we.data_ptr(), x.shape[0], n_blocks, inner,
                C, cb, _stream(x))
    if rc != 0:
        raise RuntimeError(f"trunk segment kernel launch failed: cudaError {rc}")
    trunk_segment.launches += 1
    return out


def trunk_broadcast(x: torch.Tensor, w: BroadcastWeights) -> torch.Tensor:
    """One broadcast block: x [N, 361, C] bf16 -> a new tensor of the same
    shape."""
    C = w.wf.shape[0]
    shapes = {"f_aff": (2, C), "wf": (C, C), "wdt": (MIX_PAD, MIX_PAD),
              "bd": (NUM_LOCS,), "l_aff": (2, C), "wl": (C, C)}
    for name, want in shapes.items():
        if tuple(getattr(w, name).shape) != want:
            raise ValueError(f"weight {name} is {tuple(getattr(w, name).shape)}, want {want}")
    _check_x(x, C)
    _check_weights(x, w)
    if x.device.type == "cpu":
        return trunk_broadcast_reference(x, w)
    if C not in BROADCAST_WIDTHS:
        raise ValueError(f"the broadcast kernel takes channels in "
                         f"{BROADCAST_WIDTHS}, not {C}")
    _check_launchable(x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = _broadcast_kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), w.f_aff.data_ptr(), w.wf.data_ptr(),
                w.wdt.data_ptr(), w.bd.data_ptr(), w.l_aff.data_ptr(),
                w.wl.data_ptr(), x.shape[0], C, _stream(x))
    if rc != 0:
        raise RuntimeError(f"trunk broadcast kernel launch failed: cudaError {rc}")
    trunk_broadcast.launches += 1
    return out


trunk_segment.launches = 0
trunk_broadcast.launches = 0
