"""The trunk's pre-activation mish(x * a + b) on NCHW boards: the eager
PyTorch ops and a hand-written CUDA kernel that gives the same bits.

Not a port of a TPU kernel: in the JAX package XLA fuses each inference
BatchNorm affine and mish into its neighbours. PyTorch's eager forward runs
them as ten elementwise kernels, each a pass over device memory: `x * a`,
`+ b`, and mish's `clamp`, `exp`, `u * u`, `2 * u`, `+`, `x * n`, `n + 2`
and `/`. `csrc/preact.cu` reads x once and writes y once.

`mish_affine` is the call sites' entry: the plain model's `ConvBlock`
(inference BatchNorm, then mish) and broadcast mish, and `nn/serve.py`'s
chain heads and in-chain mish (`conv_mish`). It launches the kernel where
`engages(x)`: a CUDA tensor in bf16 or float32 with no gradient being
recorded (the kernel has no backward). There the kernel's wrapper raises on
a shape, layout or alignment it cannot take, so a change that hands the
trunk such an activation fails loudly rather than leaving the kernel. The
trunk's activations are channels_last on the card (the stem permutes NHWC
planes and cuDNN keeps the layout), the broadcast mix hands back
contiguous NCHW. Everywhere else (the CPU, the train step and BN refresh,
float16 and float64) it runs the eager ops, `preact_reference`, and a CUDA
call that does so adds to `preact.plain_calls`. The kernel rounds each
step where the eager op rounds, so both give the same bits and the search,
the games and the checks do not depend on which ran.

`preact` is the kernel's wrapper (on a CPU tensor it runs
`preact_reference`); `preact.launches` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.ops.cuda_build import load_library

SOURCE = "preact.cu"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_AB_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}  # csrc/preact.cu AbKind


def mish(x: torch.Tensor) -> torch.Tensor:
    """mish(x) = x * tanh(softplus(x)) as one rational in u = e^x:
    tanh(log(1 + u)) = (u^2 + 2u) / (u^2 + 2u + 2). The exponent input is
    clamped at 20 (exact: mish(x) rounds to x there). The formula of the
    JAX package's models/blocks.py:20, which the flax model and the folded
    serving forward use. The fused trunk uses `models.blocks.mish_f32`
    instead."""
    u = torch.exp(torch.clamp(x, max=20.0))
    n = u * u + 2.0 * u
    return x * n / (n + 2.0)


def preact_reference(x: torch.Tensor, a: Optional[torch.Tensor] = None,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eager ops: mish(x * a + b), a and b per channel of axis 1 and
    cast to x's dtype first, either one None (not applied)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if a is not None:
        x = x * a.to(x.dtype).reshape(shape)
    if b is not None:
        x = x + b.to(x.dtype).reshape(shape)
    return mish(x)


def _kernel():
    lib = load_library(SOURCE)
    fn = lib.p3_preact
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _layout(x: torch.Tensor) -> Optional[int]:
    """The kernel's layout of a [N, C, 19, 19] x (0 contiguous NCHW, 1
    channels_last), or None. C must be a multiple of 8, the bf16 lanes of a
    16-byte vector, as every trunk width is."""
    if x.shape[1] % 8:
        return None
    if x.is_contiguous():
        return 0
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    return None


def _check(x: torch.Tensor, a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> None:
    if x.dim() != 4 or tuple(x.shape[2:]) != (19, 19):
        raise ValueError(f"x must be [N, C, 19, 19], got {tuple(x.shape)}")
    if _layout(x) is None:
        raise ValueError("x must have C a multiple of 8 and be contiguous or channels_last")
    if not x.is_floating_point():
        raise TypeError(f"x must be a floating-point tensor, got {x.dtype}")
    for name, v in (("a", a), ("b", b)):
        if v is None:
            continue
        if tuple(v.shape) != (x.shape[1],):
            raise ValueError(f"{name} must be [C] = [{x.shape[1]}], got {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{name} must be float32 or x's dtype {x.dtype}, got {v.dtype}")


def preact(x: torch.Tensor, a: Optional[torch.Tensor] = None,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mish(x * a + b) over channel axis 1 of a [N, C, 19, 19] tensor, C a
    multiple of 8, contiguous or channels_last, in x's layout; a and b are
    [C] in float32 or x's dtype, either one None. On a
    CUDA tensor in bf16 or float32 the kernel of `csrc/preact.cu`; on a CPU
    tensor `preact_reference`. Both give the same bits."""
    _check(x, a, b)
    if x.device.type == "cpu":
        return preact_reference(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"no preact kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the preact kernel takes bf16 or float32, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _kernel()
    ptr = lambda v: 0 if v is None else v.data_ptr()
    kind = lambda v: _AB_KIND[None if v is None else v.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), ptr(a), ptr(b), x.shape[0], x.shape[1],
                int(x.dtype == torch.bfloat16), _layout(x), kind(a), kind(b), stream)
    if rc != 0:
        raise RuntimeError(f"preact kernel launch failed: cudaError {rc}")
    preact.launches += 1
    return y


preact.launches = 0
preact.plain_calls = 0


def engages(x: torch.Tensor) -> bool:
    """Whether `mish_affine(x, ...)` launches the kernel: x on the card in
    bf16 or float32, and no gradient being recorded."""
    return x.is_cuda and x.dtype in KERNEL_DTYPES and not torch.is_grad_enabled()


def mish_affine(x: torch.Tensor, a: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mish(x * a + b) by the kernel where it `engages`, else by the eager
    ops; the same bits either way."""
    if engages(x):
        return preact(x, a, b)
    if x.is_cuda:
        preact.plain_calls += 1
    return preact_reference(x, a, b)


def conv_mish(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              padding: int) -> torch.Tensor:
    """mish(conv2d(x, w, bias)). Where the kernel engages, the bias is its
    b: on the card a convolution adds its bias after cuDNN's product as a
    separate `add_` in x's dtype, which is the kernel's rounded `+ b`."""
    if engages(x):
        return preact(F.conv2d(x, w, padding=padding), None, bias)
    return mish_affine(F.conv2d(x, w, bias, padding=padding))
