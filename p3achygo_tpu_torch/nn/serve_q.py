"""int8-activation serving graph (port of p3achygo_tpu/nn/serve_q.py, the
TRT-int8 analogue of reference cc/nn/engine/trt_engine.cc and
trt_calibrator.cc:15-74).

The trunk's streams between convolutions are stored in int8:

* Weights: BN folded into the producer conv exactly as `nn/serve.py`, then
  symmetric per-output-channel int8 (`_quant_w`).
* Activations: symmetric per-tensor int8 with static scales, calibrated as
  the `CALIB_Q` percentile of |x| at every site (record mode). The sites
  are every trunk conv input (the mish outputs) and, with
  `residual_int8`, the residual stream at each block boundary. The site
  names are the JAX package's (`res_in`, `b{i}.u{j}`, `b{i}.f.u0`,
  `b{i}.l.u0`, `b{i}.r.u0`, `b{i}.nbt_res{0,1}.u{0,1}`, `b{i}.e.u0`,
  `res{i}`), so a JAX scale dict serves here unchanged
  (`bridge.scales_from_jax`).
* Convolutions: s8 x s8 -> s32 with dequantize + bias + mish + requantize
  fused into one call, `ops/conv_i8.py conv_i8` (the kernel of
  `csrc/conv_i8.cu` on the card, its plain version on the CPU), where JAX
  has XLA's int32 convolution and the output fusion XLA makes of the chain
  after it. `native=False` is the JAX package's emulation instead: a
  float32 convolution of the int8 values, rounded, exact only while
  fan_in * 127^2 < 2^24 (3x3 up to 64 channels); its epilogues are the
  same plain ops the CPU runs.
* The stem, the broadcast mix and the heads stay in the compute dtype
  (`nn/serve.py FoldedStem`, `FoldedHeads`).

The trunk runs NHWC ([N, 19, 19, C], channels innermost, as the kernel
reads them). Serving with `residual_int8` (the default) keeps the residual
stream int8 in device memory between blocks, (q8, its `res{i}` scale):
each block's last conv adds the stream, requantizes it and runs the next
block's first chain head in its epilogue (conv_i8's RES mode), and a
broadcast block's conv_first writes mish in the compute dtype in the
[N, C, 361] layout the mix reads (MISH). Still plain PyTorch there: the
head of the first chain after the stem (`res_in`, once a forward), the
head of each broadcast block's last chain (after the mix), the mix itself
(`dense_rounded`) and the nbt block's inner residual add. Each
quantization still happens once per JAX site in JAX's order (`res{i}`,
then the next `b{i+1}...u0`). Record mode and `residual_int8=False` keep
the float32 stream between blocks (JAX's values times their scale),
through the F32 epilogue and plain ops; so does `fused=False`, which gives
the same numbers as the fused graph.
`ServeQNet` folds and quantizes the weights once and takes the scale dict
as an argument, so one net serves every calibration (JAX passes the scales
as traced arguments for the same reason). The scales stay on the device:
no call reads one back to the host.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.models.blocks import mish
from p3achygo_tpu_torch.models.model import P3achyGoModel
from p3achygo_tpu_torch.nn.serve import (FoldedHeads, FoldedStem, _Caster, block_plan,
                                         dense_rounded, fold_chain, serve_supported)
from p3achygo_tpu_torch.ops.conv_i8 import (conv_i8, conv_i8_acc, epilogue_reference,
                                            quantize)

# Calibration percentile of |x| per site: clips the far mish tail (a few
# outliers per 10^6 activations) instead of stretching the int8 grid.
CALIB_Q = 99.97

Scales = Dict[str, torch.Tensor]


def q_supported(config) -> bool:
    return serve_supported(config)


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as a true division on every device (on the card PyTorch turns a
    division by a Python number into a product with its reciprocal)."""
    return t / torch.full((), c, dtype=t.dtype, device=t.device)


def _quant_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a weight whose output channel is
    axis 0; returns (w8, scale[oc]) with scale = max|w| / 127 floored at
    1e-12."""
    s = torch.clamp(_div(w.abs().amax(dim=tuple(range(1, w.dim()))), 127.0), min=1e-12)
    w8 = torch.clamp(torch.round(w / s.reshape((-1,) + (1,) * (w.dim() - 1))), -127, 127)
    return w8.to(torch.int8), s.float()


def _quant_a(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return quantize(x, scale)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, pad: int) -> torch.Tensor:
    """'SAME' convolution of NHWC x by an OIHW weight, NHWC out."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad).permute(0, 2, 3, 1).contiguous()


def _conv_i8(x8: torch.Tensor, w8: torch.Tensor, native: bool) -> torch.Tensor:
    """s8 x s8 conv -> s32 NHWC (w8 [Cout, K, K, Cin]): exact (`native`, the
    kernel's raw sums on the card), or JAX's float32 emulation rounded."""
    if native:
        return conv_i8_acc(x8, w8)
    pad = w8.shape[1] // 2
    w = w8.permute(0, 3, 1, 2).float()
    if x8.device.type == "cuda":
        # cuDNN may pick a Winograd or FFT algorithm, whose transforms are
        # not exact on integers; the plain convolution is, below 2^24.
        with torch.backends.cudnn.flags(enabled=False):
            y = _conv_nhwc(x8.float(), w, pad)
    else:
        y = _conv_nhwc(x8.float(), w, pad)
    return torch.round(y).to(torch.int32)


def percentile_abs(x: torch.Tensor, q: float = CALIB_Q) -> torch.Tensor:
    """The q-th percentile of |x| as a 0-d float32 tensor on x's device, by
    jnp.percentile's default 'linear' rule with its float32 rank (q / 100 *
    (n - 1), floor and ceil, weights rank - floor and 1 - that). Selects the
    two order statistics with `topk` (`torch.quantile` refuses inputs over
    2^24 elements)."""
    a = x.detach().float().abs().reshape(-1)
    n = a.numel()
    rank = np.float32(q) / np.float32(100.0) * (np.float32(n) - np.float32(1.0))
    low, high = np.floor(rank), np.ceil(rank)
    w_high = np.float32(rank - low)
    w_low = np.float32(1.0) - w_high
    low, high = (int(min(max(v, 0), n - 1)) for v in (low, high))
    top = torch.topk(a, n - low).values  # descending: top[-1] is a_sorted[low]
    v_low = top[-1]
    v_high = top[-2] if high > low else v_low
    return v_low * float(w_low) + v_high * float(w_high)


class _Ctx:
    """Walk context: records each site's scale (calibration) or reads the
    calibrated ones (quantized serving)."""

    def __init__(self, scales: Optional[Scales], native: bool):
        self.record = scales is None
        self.scales: Scales = {} if self.record else scales
        self.native = native

    def scale(self, site: str, x: torch.Tensor) -> torch.Tensor:
        if self.record:
            s = _div(torch.clamp(percentile_abs(x), min=1e-6), 127.0)
            self.scales[site] = s
            return s
        return self.scales[site]


class _QConv(NamedTuple):
    w: torch.Tensor  # folded float32 OIHW weight (record mode)
    bias: Optional[torch.Tensor]  # folded float32 [Cout] (None: chain-last)
    pad: int
    w8: torch.Tensor  # int8 [Cout, K, K, Cin]
    s_w: torch.Tensor  # float32 [Cout]


class _QChain(NamedTuple):
    site: str
    a0: torch.Tensor  # chain-head BN affine, float32 [C]
    b0: torch.Tensor
    convs: List[_QConv]


def _q_chain(cbs, site: str) -> _QChain:
    a0, b0, convs = fold_chain(cbs)
    qconvs = []
    for w, bias, pad in convs:
        w8, s_w = _quant_w(w)
        qconvs.append(_QConv(w, bias, pad, w8.permute(0, 2, 3, 1).contiguous(), s_w))
    return _QChain(site, a0, b0, qconvs)


class ServeQNet:
    """int8-activation forward of a conv-family `P3achyGoModel`, its weights
    folded and quantized once. Call with `scales=None` to record a
    calibration (returns (outputs, scales)), else with a scale dict."""

    @torch.no_grad()
    def __init__(self, model: P3achyGoModel, want_optimistic: bool = False):
        if not q_supported(model.config):
            raise ValueError("ServeQNet: conv trunks only")
        self.dtype = model.dtype
        # Every Dense rounds as JAX's `_dense` does: the game layer and the
        # broadcast mix feed int8 sites, where a last-bit difference in bf16
        # moves a value across a rounding boundary.
        self.stem = FoldedStem(model, linear=dense_rounded)
        self.heads = FoldedHeads(model, want_optimistic, linear=dense_rounded)
        cast = _Caster(model.dtype)
        self.blocks = []
        for i, (kind, parts) in enumerate(block_plan(model)):
            site = f"b{i}"
            if kind == "chain":
                self.blocks.append((kind, _q_chain(parts, site)))
            elif kind == "broadcast":
                first, mix, last = parts
                self.blocks.append((kind, (_q_chain(first, f"{site}.f"), cast.dense(mix),
                                           _q_chain(last, f"{site}.l"))))
            else:
                reduce, res, expand = parts
                self.blocks.append((kind, (
                    _q_chain(reduce, f"{site}.r"),
                    [_q_chain(r, f"{site}.nbt_res{j}") for j, r in enumerate(res)],
                    _q_chain(expand, f"{site}.e"))))

    @staticmethod
    def _head(x: torch.Tensor, chain: _QChain, ctx: _Ctx) -> torch.Tensor:
        """A chain's head on NHWC x in plain ops: the BN affine and mish in
        float32, quantized at the chain's first site."""
        return _quant_a(mish(x.float() * chain.a0 + chain.b0), ctx.scales[f"{chain.site}.u0"])

    @staticmethod
    def _convs(u8: torch.Tensor, chain: _QChain, ctx: _Ctx, **last):
        """A chain's convolutions from its head's int8 output: each in-chain
        conv's output requantized for the next, the last conv's epilogue
        chosen by `last` (`conv_i8`'s keywords; float32 when empty)."""
        for i, c in enumerate(chain.convs):
            s_in = ctx.scales[f"{chain.site}.u{i}"]
            epilogue = (dict(s_next=ctx.scales[f"{chain.site}.u{i + 1}"])
                        if i + 1 < len(chain.convs) else last)
            if ctx.native:
                u8 = conv_i8(u8, c.w8, s_in, c.s_w, c.bias, **epilogue)
            else:
                u8 = epilogue_reference(_conv_i8(u8, c.w8, False), s_in, c.s_w, c.bias,
                                        **epilogue)
        return u8

    @classmethod
    def _chain(cls, x: torch.Tensor, chain: _QChain, ctx: _Ctx) -> torch.Tensor:
        """A ConvBlock chain on NHWC x: the head, every conv input quantized
        at its site's scale; the last conv's output in float32."""
        if not ctx.record:
            return cls._convs(cls._head(x, chain, ctx), chain, ctx)
        # Calibration runs the fold math in float32, unquantized.
        u = mish(x.float() * chain.a0 + chain.b0)
        for i, c in enumerate(chain.convs):
            ctx.scale(f"{chain.site}.u{i}", u)
            y = _conv_nhwc(u, c.w, c.pad)
            if c.bias is not None:
                y = y + c.bias
            if i + 1 < len(chain.convs):
                u = mish(y)
        return y

    def _residual(self, x: torch.Tensor, site: str, ctx: _Ctx,
                  residual_int8: bool) -> torch.Tensor:
        """The residual stream's storage at a block boundary."""
        if not residual_int8:
            return x.to(self.dtype).float()
        s_x = ctx.scale(site, x)
        if ctx.record:
            return x
        return _quant_a(x, s_x).float() * s_x

    def _mix(self, m: torch.Tensor, mix) -> torch.Tensor:
        """The broadcast mix on [N, C, 361] in the compute dtype -> NHWC.
        The product reads m contiguous in both graphs: cuBLAS picks another
        kernel, which rounds differently, for the strided view the plain
        graph's permute gives."""
        n, c, _ = m.shape
        z = dense_rounded(m.contiguous(), *mix)
        return z.reshape(n, c, 19, 19).permute(0, 2, 3, 1).contiguous()

    def _block(self, x: torch.Tensor, kind: str, p, ctx: _Ctx) -> torch.Tensor:
        """One block's residual branch d on the float32 stream x."""
        if kind == "chain":
            return self._chain(x, p, ctx)
        if kind == "broadcast":
            first, mix, last = p
            m = mish(self._chain(x, first, ctx)).to(self.dtype)
            n, h, w, c = m.shape
            return self._chain(self._mix(m.permute(0, 3, 1, 2).reshape(n, c, h * w), mix),
                               last, ctx)
        reduce, res, expand = p
        h_ = self._chain(x, reduce, ctx)
        for r in res:
            h_ = h_ + self._chain(h_, r, ctx)
        return self._chain(h_, expand, ctx)

    @staticmethod
    def _first_chain(kind: str, p) -> _QChain:
        return p if kind == "chain" else p[0]

    def _fused_trunk(self, x: torch.Tensor, ctx: _Ctx) -> torch.Tensor:
        """The trunk with the int8 residual stream (q8, its scale) between
        blocks: each block's last conv adds the stream, requantizes it at
        `res{i}` and runs the next block's first chain head (conv_i8's RES
        epilogue), and a broadcast block's conv_first writes mish in the
        compute dtype as the mix reads it (MISH). Returns the last
        stream, dequantized."""
        s = ctx.scales["res_in"]
        q = _quant_a(x, s)
        u8 = None  # the block's first chain head, when the last boundary fused it
        for i, (kind, p) in enumerate(self.blocks):
            if u8 is None:
                u8 = self._head(q.float() * s, self._first_chain(kind, p), ctx)
            s_res = ctx.scales[f"res{i}"]
            res = dict(q_prev=q, s_prev=s, s_res=s_res)
            if i + 1 < len(self.blocks):
                nxt = self._first_chain(*self.blocks[i + 1])
                res.update(a0=nxt.a0, b0=nxt.b0, s_head=ctx.scales[f"{nxt.site}.u0"])
            if kind == "chain":
                q, u8 = self._convs(u8, p, ctx, **res)
            elif kind == "broadcast":
                first, mix, last = p
                z = self._mix(self._convs(u8, first, ctx, mish_dtype=self.dtype), mix)
                q, u8 = self._convs(self._head(z, last, ctx), last, ctx, **res)
            else:
                reduce, inner, expand = p
                h_ = self._convs(u8, reduce, ctx)
                for r in inner:
                    h_ = h_ + self._chain(h_, r, ctx)
                q, u8 = self._convs(self._head(h_, expand, ctx), expand, ctx, **res)
            s = s_res
        return q.float() * s

    def _trunk(self, board_state: torch.Tensor, game_state: torch.Tensor, ctx: _Ctx,
               residual_int8: bool, fused: bool) -> torch.Tensor:
        """Stem and trunk: the float32 NHWC stream the heads read."""
        x = self.stem(board_state, game_state).permute(0, 2, 3, 1).contiguous().float()
        if residual_int8 and fused and not ctx.record:
            return self._fused_trunk(x, ctx)
        x = self._residual(x, "res_in", ctx, residual_int8)
        for i, (kind, p) in enumerate(self.blocks):
            x = self._residual(x + self._block(x, kind, p, ctx), f"res{i}", ctx,
                               residual_int8)
        return x

    @torch.no_grad()
    def stream(self, board_state: torch.Tensor, game_state: torch.Tensor, scales: Scales,
               native: bool = True, fused: bool = True) -> torch.Tensor:
        """The trunk's last residual stream (int8 values times their scale,
        float32 NHWC), as the heads read it."""
        return self._trunk(board_state, game_state, _Ctx(scales, native), True, fused)

    @torch.no_grad()
    def __call__(self, board_state: torch.Tensor, game_state: torch.Tensor,
                 scales: Optional[Scales] = None, native: bool = True,
                 residual_int8: bool = True, fused: bool = True):
        """The forward; `fused` (serving with `residual_int8`) keeps the
        stream int8 between blocks through conv_i8's RES and MISH
        epilogues, and without it the same values come from its F32
        epilogue and plain ops."""
        ctx = _Ctx(scales, native)
        x = self._trunk(board_state, game_state, ctx, residual_int8, fused)
        out = self.heads(x.to(self.dtype).permute(0, 3, 1, 2).contiguous())
        return (out, ctx.scales) if ctx.record else out


def serve_q_forward(model: P3achyGoModel, board_state: torch.Tensor,
                    game_state: torch.Tensor, scales: Optional[Scales] = None,
                    want_optimistic: bool = False, native: bool = True,
                    residual_int8: bool = True):
    """int8-activation forward. With `scales=None` runs in record mode
    (float32 folded math) and returns (ModelOutputs, site -> scale);
    with a scale dict returns ModelOutputs. `native=False` emulates the
    integer convolutions in float32 as the JAX package does; `residual_int8`
    also stores the block-boundary residual stream in int8. Folds and
    quantizes `model` on every call: serving builds a `ServeQNet` once."""
    return ServeQNet(model, want_optimistic)(board_state, game_state, scales, native,
                                             residual_int8)


def calibrate(model: P3achyGoModel, planes: torch.Tensor, scalars: torch.Tensor,
              want_optimistic: bool = False, residual_int8: bool = True) -> Scales:
    """One-shot scale calibration from a batch of real positions (the
    trt_calibrator.cc analogue): site -> 0-d float32 scale on the planes'
    device."""
    _, scales = serve_q_forward(model, planes, scalars, None, want_optimistic,
                                residual_int8=residual_int8)
    return scales
