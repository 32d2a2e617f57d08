"""int8 x int8 -> int32 convolution of 19x19 boards on the s8 tensor cores
with the int8 serving graph's epilogue fused in: the hand-written CUDA
kernel and its plain PyTorch version.

Not a port of a TPU kernel: in the JAX package this is XLA's convolution
with `preferred_element_type=int32` plus the elementwise work XLA fuses
into its output (p3achygo_tpu/nn/serve_q.py `_conv_i8`, `_chain_q`, the
next convolution's `_quant_a`, and at a block boundary `requant_res` and
the next chain's head). PyTorch has no int8 convolution on the card, so
`nn/serve_q.py` runs every int8 convolution through `conv_i8`. With
y = float(sum x8 * w8) * (s_in * s_w[oc]) (+ bias[oc]), the epilogue is
chosen by the arguments:

    s_next:       clip(round_half_even(mish(y) / s_next), -127, 127) int8
    q_prev:       the residual (RES): r = float(q_prev) * s_prev + y,
                  q8 = quantize(r, s_res), and with a0, b0, s_head the
                  next chain's head u8 = quantize(mish(float(q8) * s_res
                  * a0 + b0), s_head); returns (q8, u8 or None)
    mish_dtype:   mish(y) in that dtype (MISH), [N, Cout, 361]
    none of them: y float32

Activations are NHWC ([N, 19, 19, Cin], channels innermost), weights
[Cout, K, K, Cin] with K in {1, 3} and 'SAME' padding; scales are float32
tensors on the activations' device (s_in, s_next, s_prev, s_res and s_head
one element, s_w, bias, a0 and b0 [Cout]), so no scale is read back to the
host.

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
TILE_OC = 64  # output channels per block (csrc/conv_i8.cu kTileOc)
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100
MODES = ("acc", "f32", "i8", "res", "mish")
_MODE_ACC, _MODE_F32, _MODE_I8, _MODE_RES, _MODE_MISH_F32, _MODE_MISH_BF16 = range(6)
_MISH_MODES = {torch.float32: _MODE_MISH_F32, torch.bfloat16: _MODE_MISH_BF16}


def smem_bytes(k: int, cin: int, stages: int = 1) -> int:
    """Shared memory of one block (csrc/conv_i8.cu `smem_bytes`): a tile of
    64 output channels' weights, each row K*K*Cp + 16 bytes (Cp = Cin padded
    to 32), their four per-channel constants, 8 warps' int8 staging tiles
    of 16 x 48 bytes, and `stages` boards of 19x19 points (21x21 with the
    halo for 3x3) at Cp + 16 bytes each."""
    cp = -(-cin // 32) * 32
    width = 19 + 2 * (k // 2)
    return (TILE_OC * (k * k * cp + 16) + 4 * TILE_OC * 4 + 8 * 16 * 48
            + stages * width * width * (cp + 16))


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
                       s_next: Optional[torch.Tensor] = None, *,
                       q_prev: Optional[torch.Tensor] = None,
                       s_prev: Optional[torch.Tensor] = None,
                       s_res: Optional[torch.Tensor] = None,
                       a0: Optional[torch.Tensor] = None, b0: Optional[torch.Tensor] = None,
                       s_head: Optional[torch.Tensor] = None,
                       mish_dtype: Optional[torch.dtype] = None):
    """The plain ops after the convolution, in the JAX package's order:
    dequantize and add the folded bias (`_chain_q`); then with `s_next`
    quantize mish(y) for the next convolution; with `q_prev` add the
    residual stream, requantize it (`requant_res`) and, with `a0`, run the
    next chain's head and its first `_quant_a` (`_chain_q`), returning
    (q8, u8 or None); with `mish_dtype` mish(y) in that dtype as the
    broadcast mix reads it, [N, Cout, 361]."""
    y = acc.float() * (s_in * s_w)
    if bias is not None:
        y = y + bias
    if s_next is not None:
        return quantize(mish(y), s_next)
    if q_prev is not None:
        q8 = quantize(q_prev.float() * s_prev + y, s_res)
        if a0 is None:
            return q8, None
        return q8, quantize(mish(q8.float() * s_res * a0 + b0), s_head)
    if mish_dtype is not None:
        n, h, w, c = y.shape
        return mish(y).to(mish_dtype).permute(0, 3, 1, 2).reshape(n, c, h * w).contiguous()
    return y


def conv_i8_reference(x8, w8, s_in, s_w, bias=None, s_next=None, **epilogue):
    """Plain version of `conv_i8`."""
    return epilogue_reference(conv_i8_acc_reference(x8, w8), s_in, s_w, bias, s_next,
                              **epilogue)


def _kernel():
    lib = load_library(SOURCE)
    fn = lib.p3_conv_i8
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


def _check_epilogue(x8, cout, s_next, q_prev, s_prev, s_res, a0, b0, s_head, mish_dtype):
    """Which epilogue the arguments ask for ("i8", "res", "mish" or "f32");
    raises where they are not one whole set."""
    asked = [m for m, on in (("i8", s_next is not None), ("res", q_prev is not None),
                             ("mish", mish_dtype is not None)) if on]
    if len(asked) > 1:
        raise ValueError(f"conv_i8: one epilogue at a time, got {asked}")
    mode = asked[0] if asked else "f32"
    res_args = (s_prev, s_res, a0, b0, s_head)
    if mode != "res" and any(t is not None for t in res_args):
        raise ValueError("conv_i8: s_prev, s_res, a0, b0 and s_head go with q_prev")
    if mode == "res":
        if s_prev is None or s_res is None:
            raise ValueError("conv_i8: q_prev needs s_prev and s_res")
        if len({a0 is None, b0 is None, s_head is None}) != 1:
            raise ValueError("conv_i8: a0, b0 and s_head go together")
        if (q_prev.dtype != torch.int8 or q_prev.device != x8.device
                or tuple(q_prev.shape) != (*x8.shape[:3], cout)):
            raise ValueError(f"conv_i8: q_prev must be int8 {(*x8.shape[:3], cout)} on "
                             f"{x8.device}, got {q_prev.dtype} {tuple(q_prev.shape)} on "
                             f"{q_prev.device}")
    if mode == "mish" and mish_dtype not in _MISH_MODES:
        raise ValueError(f"conv_i8: mish_dtype {mish_dtype} (float32 or bfloat16 only)")
    return mode


def _launch(mode, outs, x8, w8, s_in=None, s_w=None, bias=None, s_next=None, q_prev=None,
            s_prev=None, s_res=None, a0=None, b0=None, s_head=None):
    """Launch the kernel of csrc/conv_i8.cu in `mode` into `outs` (one or
    two tensors); False when the batch is empty (nothing launched)."""
    if x8.device.type != "cuda":
        raise ValueError(f"no conv_i8 kernel for device {x8.device}")
    k, cin, cout = w8.shape[1], x8.shape[3], w8.shape[0]
    check_widths(k, cin, cout)
    if not all(t is None or t.is_contiguous() for t in (x8, w8, s_w, bias, q_prev, a0, b0)):
        raise ValueError("conv_i8: x8, w8, s_w, bias, q_prev, a0 and b0 must be contiguous")
    if any(t is not None and t.data_ptr() % 4 for t in (x8, w8, q_prev)):
        raise ValueError("conv_i8: x8, w8 and q_prev must start 4-byte aligned")
    if x8.shape[0] == 0:
        return False
    ptr = lambda t: None if t is None else t.data_ptr()
    outs = list(outs) + [None] * (2 - len(outs))
    ptrs = (ctypes.c_void_p * 14)(*[ptr(t) for t in (x8, w8, s_in, s_w, bias, s_next, q_prev,
                                                      s_prev, s_res, a0, b0, s_head, *outs)])
    fn = _kernel()
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        rc = fn(ctypes.addressof(ptrs), mode, k, x8.shape[0], cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"conv_i8 kernel launch failed: cudaError {rc}")
    return True


def conv_i8(x8: torch.Tensor, w8: torch.Tensor, s_in: torch.Tensor,
            s_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
            s_next: Optional[torch.Tensor] = None, *,
            q_prev: Optional[torch.Tensor] = None, s_prev: Optional[torch.Tensor] = None,
            s_res: Optional[torch.Tensor] = None, a0: Optional[torch.Tensor] = None,
            b0: Optional[torch.Tensor] = None, s_head: Optional[torch.Tensor] = None,
            mish_dtype: Optional[torch.dtype] = None):
    """int8 convolution with the fused epilogue the arguments choose (see
    the module docstring): [N, 19, 19, Cout] int8 with `s_next`
    (in-chain), (q8, u8 or None) with `q_prev` (a block's last
    convolution), [N, Cout, 361] `mish_dtype` with that (the broadcast
    block's conv_first), else float32 (a chain's last convolution)."""
    cout = w8.shape[0]
    _check(x8, w8, (("s_in", s_in, 1), ("s_w", s_w, cout), ("bias", bias, cout),
                    ("s_next", s_next, 1), ("s_prev", s_prev, 1), ("s_res", s_res, 1),
                    ("a0", a0, cout), ("b0", b0, cout), ("s_head", s_head, 1)))
    mode = _check_epilogue(x8, cout, s_next, q_prev, s_prev, s_res, a0, b0, s_head,
                           mish_dtype)
    res = dict(q_prev=q_prev, s_prev=s_prev, s_res=s_res, a0=a0, b0=b0, s_head=s_head)
    if x8.device.type == "cpu":
        return conv_i8_reference(x8, w8, s_in, s_w, bias, s_next, **res,
                                 mish_dtype=mish_dtype)
    n = x8.shape[0]
    new = lambda shape, dtype: torch.empty(shape, device=x8.device, dtype=dtype)
    if mode == "res":
        outs = (new((n, 19, 19, cout), torch.int8),
                None if a0 is None else new((n, 19, 19, cout), torch.int8))
        code = _MODE_RES
    elif mode == "mish":
        outs, code = (new((n, cout, 361), mish_dtype),), _MISH_MODES[mish_dtype]
    else:
        outs = (new((n, 19, 19, cout), torch.int8 if mode == "i8" else torch.float32),)
        code = _MODE_I8 if mode == "i8" else _MODE_F32
    if _launch(code, outs, x8, w8, s_in, s_w, bias, s_next, **res):
        conv_i8.launches += 1
        conv_i8.mode_launches[mode] += 1
    return outs if mode == "res" else outs[0]


def conv_i8_acc(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of `conv_i8`, [N, 19, 19, Cout] (the kernel in
    its raw mode; checks and JAX's `_conv_i8(native=True)`)."""
    _check(x8, w8, ())
    if x8.device.type == "cpu":
        return conv_i8_acc_reference(x8, w8)
    out = torch.empty((*x8.shape[:3], w8.shape[0]), device=x8.device, dtype=torch.int32)
    _launch(_MODE_ACC, (out,), x8, w8)
    return out


def reset_launches() -> None:
    """Set every launch count of the kernel to 0 (the total and by mode)."""
    conv_i8.launches = 0
    conv_i8.mode_launches = {m: 0 for m in MODES[1:]}


reset_launches()
