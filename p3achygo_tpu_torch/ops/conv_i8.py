"""int8 x int8 -> int32 convolution of 19x19 boards with the int8 serving
graph's epilogue fused in: the hand-written CUDA kernel and its plain
PyTorch version.

Not a port of a TPU kernel: in the JAX package this is XLA's convolution
with `preferred_element_type=int32` plus the elementwise chain XLA fuses
into its output (p3achygo_tpu/nn/serve_q.py `_conv_i8`, `_chain_q` and the
next convolution's `_quant_a`). PyTorch has no int8 convolution on the
card, so `nn/serve_q.py` runs every int8 convolution through `conv_i8`:

    y = float(sum x8 * w8) * (s_in * s_w[oc])  (+ bias[oc])
    s_next given:  clip(round_half_even(mish(y) / s_next), -127, 127) int8
    s_next None:   y float32

Activations are NHWC ([N, 19, 19, Cin], channels innermost), weights
[Cout, K, K, Cin] with K in {1, 3} and 'SAME' padding; scales are float32
tensors on the activations' device (s_in and s_next one element, s_w and
bias [Cout]), so no scale is read back to the host.

On a CUDA tensor `conv_i8` launches `csrc/conv_i8.cu` or raises; on a CPU
tensor it runs `conv_i8_reference`. Both give the same numbers: the sums
are exact integers, and the kernel rounds its epilogue where these ops
round. `conv_i8_acc` returns the raw int32 sums (the same kernel, mode 0),
so a check can hold them equal before any float is involved.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.models.blocks import mish
from p3achygo_tpu_torch.ops.cuda_build import load_library

SOURCE = "conv_i8.cu"
TILE_OC = 32  # output channels per block (csrc/conv_i8.cu kTileOc)
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100
_MODE_ACC, _MODE_F32, _MODE_I8 = 0, 1, 2


def smem_bytes(k: int, cin: int) -> int:
    """Shared memory of one block: the board as Cin/4 words per point of a
    19x19 plane (21x21 with the halo for 3x3), rounded up to 16 bytes, and
    a tile of 32 output channels' weights."""
    width = 19 + 2 * (k // 2)
    cin4 = cin // 4
    plane = (cin4 * width * width + 3) & ~3
    return 4 * (plane + k * k * cin4 * TILE_OC)


def check_widths(k: int, cin: int, cout: int) -> None:
    """Raise ValueError, naming the widths, where the kernel cannot run."""
    if k not in (1, 3):
        raise ValueError(f"conv_i8: kernel size {k} (1 or 3 only)")
    if cin % 4 or cout % 8 or cin <= 0 or cout <= 0:
        raise ValueError(f"conv_i8: Cin={cin} must be a multiple of 4 and Cout={cout} "
                         f"of 8")
    if smem_bytes(k, cin) > SMEM_LIMIT:
        raise ValueError(f"conv_i8: a {k}x{k} convolution over Cin={cin} needs "
                         f"{smem_bytes(k, cin)} bytes of shared memory a block, "
                         f"more than the {SMEM_LIMIT} an H100 gives")


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8: clip(round_half_even(x / scale), +-127)
    (JAX serve_q.py `_quant_a`)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def conv_i8_acc_reference(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain version of the sums: int8 NHWC x [Cout, K, K, Cin] -> int32
    NHWC. PyTorch has no integer convolution on the card, so the sums are
    taken in float64, where every product and partial sum of int8 values is
    an integer far below 2^53 and so exact in any order (the rounding only
    removes the error of a transform-based algorithm)."""
    y = F.conv2d(x8.permute(0, 3, 1, 2).double(), w8.permute(0, 3, 1, 2).double(),
                 padding=w8.shape[1] // 2)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def epilogue_reference(acc: torch.Tensor, s_in: torch.Tensor, s_w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       s_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX serve_q.py `_chain_q` after the convolution: dequantize, add the
    folded bias, and with `s_next` quantize mish(y) for the next one."""
    y = acc.float() * (s_in * s_w)
    if bias is not None:
        y = y + bias
    if s_next is None:
        return y
    return quantize(mish(y), s_next)


def conv_i8_reference(x8, w8, s_in, s_w, bias=None, s_next=None) -> torch.Tensor:
    """Plain version of `conv_i8`."""
    return epilogue_reference(conv_i8_acc_reference(x8, w8), s_in, s_w, bias, s_next)


def _kernel():
    lib = load_library(SOURCE)
    fn = lib.p3_conv_i8
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x8, w8, scales) -> None:
    if x8.dim() != 4 or tuple(x8.shape[1:3]) != (19, 19):
        raise ValueError(f"x8 must be [N, 19, 19, Cin], got {tuple(x8.shape)}")
    if w8.dim() != 4 or w8.shape[1] != w8.shape[2] or w8.shape[3] != x8.shape[3]:
        raise ValueError(f"w8 must be [Cout, K, K, {x8.shape[3]}], got {tuple(w8.shape)}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"want int8 x8 and w8, got {x8.dtype} and {w8.dtype}")
    for name, t, numel in scales:
        if t is None:
            continue
        if t.dtype != torch.float32 or t.numel() != numel:
            raise ValueError(f"{name} must be {numel} float32 values, got "
                             f"{t.numel()} {t.dtype}")
        if t.device != x8.device:
            raise ValueError(f"{name} on {t.device}, x8 on {x8.device}")
    if w8.device != x8.device:
        raise ValueError(f"w8 on {w8.device}, x8 on {x8.device}")


def _launch(mode, out, x8, w8, s_in=None, s_w=None, bias=None, s_next=None):
    """Launch the kernel of csrc/conv_i8.cu in `mode` into `out`; False
    when the batch is empty (nothing launched)."""
    if x8.device.type != "cuda":
        raise ValueError(f"no conv_i8 kernel for device {x8.device}")
    k, cin, cout = w8.shape[1], x8.shape[3], w8.shape[0]
    check_widths(k, cin, cout)
    if not all(t is None or t.is_contiguous() for t in (x8, w8, s_w, bias)):
        raise ValueError("conv_i8: x8, w8, s_w and bias must be contiguous")
    if x8.shape[0] == 0:
        return False
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _kernel()
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        rc = fn(x8.data_ptr(), w8.data_ptr(), ptr(s_in), ptr(s_w), ptr(bias),
                ptr(s_next), out.data_ptr(), mode, k, x8.shape[0], cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"conv_i8 kernel launch failed: cudaError {rc}")
    return True


def conv_i8(x8: torch.Tensor, w8: torch.Tensor, s_in: torch.Tensor,
            s_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
            s_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 convolution with the fused epilogue: [N, 19, 19, Cout] int8
    with `s_next` (in-chain), else float32 (chain-last)."""
    cout = w8.shape[0]
    _check(x8, w8, (("s_in", s_in, 1), ("s_w", s_w, cout), ("bias", bias, cout),
                    ("s_next", s_next, 1)))
    if x8.device.type == "cpu":
        return conv_i8_reference(x8, w8, s_in, s_w, bias, s_next)
    out = torch.empty((*x8.shape[:3], cout), device=x8.device,
                      dtype=torch.float32 if s_next is None else torch.int8)
    mode = _MODE_F32 if s_next is None else _MODE_I8
    if _launch(mode, out, x8, w8, s_in, s_w, bias, s_next):
        conv_i8.launches += 1
    return out


def conv_i8_acc(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of `conv_i8`, [N, 19, 19, Cout] (the kernel in
    its raw mode; checks and JAX's `_conv_i8(native=True)`)."""
    _check(x8, w8, ())
    if x8.device.type == "cpu":
        return conv_i8_acc_reference(x8, w8)
    out = torch.empty((*x8.shape[:3], w8.shape[0]), device=x8.device, dtype=torch.int32)
    if _launch(_MODE_ACC, out, x8, w8):
        conv_i8_acc.launches += 1
    return out


conv_i8.launches = 0
conv_i8_acc.launches = 0
