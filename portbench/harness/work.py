"""Work counts from shapes and the published peaks of one NVIDIA H100.

Frozen copies of the repo's counting functions (chip_smoke.py
`segment_work`, `broadcast_work`, `bound_ms`, `PEAK_*`), taking the shapes
of a call instead of the program's weight tensors, so that what a later
change to the program packs or pads does not change the count. Each input
byte is read once and each output byte written once; operations are those
the layer's products need (2 per multiply-add). `model_flops` counts one
position's forward: the stem, the trunk (`flops` of the configuration's
trunk module, `reference/trunks/`), and the head layers that produce
what search reads (policy logits and pass, outcome, q6 error, gamma, score
distribution), whatever implements them.
"""
from __future__ import annotations

from typing import Tuple

from portbench.harness.cells import BENCH_DIR, trunk_module

POINTS = 361
# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
BF16, F32, I8, I32 = 2, 4, 1, 4


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card can take: the larger of operations over the
    peak rate and bytes over the memory bandwidth."""
    return max(flops / peak, nbytes / PEAK_BYTES_S)


def segment_work(n: int, n_blocks: int, layers: int, C: int, cb: int) -> Tuple[float, float]:
    """(operations, bytes) of one segment call on n boards: `n_blocks`
    bottleneck blocks of a 1x1 reduce C -> cb, `layers - 2` 3x3 layers
    cb -> cb and a 1x1 expand cb -> C. x read and written once in bf16; the
    bf16 weights and the float32 (scale, shift) of each layer's input read
    once."""
    inner = layers - 2
    flops = n_blocks * n * 2 * POINTS * (2 * C * cb + 9 * inner * cb * cb)
    weights = n_blocks * (2 * C * cb + 9 * inner * cb * cb) * BF16
    affines = n_blocks * layers * 2 * C * F32
    return flops, 2 * n * POINTS * C * BF16 + weights + affines


def broadcast_work(n: int, C: int) -> Tuple[float, float]:
    """(operations, bytes) of one broadcast call on n boards: conv_first
    and conv_last (1x1, C -> C) and the 361 x 361 position mix; x in and
    out in bf16, the two bf16 kernels, the bf16 mix and its float32 bias,
    and two float32 (scale, shift) pairs read once."""
    flops = n * 2 * (2 * POINTS * C * C + POINTS * POINTS * C)
    weights = (2 * C * C + POINTS * POINTS) * BF16 + POINTS * F32 + 2 * 2 * C * F32
    return flops, 2 * n * POINTS * C * BF16 + weights


def liberty_bytes(n: int) -> float:
    """Bytes of one liberty call on n boards: int8 stones and int32 chain
    ids in, int32 liberties out."""
    return n * POINTS * (I8 + I32 + I32)


def model_flops(cfg: dict, bench_dir: str = BENCH_DIR) -> float:
    """Operations of one position's forward (see the module docstring): the
    stem, the configuration's trunk (its module's `flops`) and the heads at
    the trunk's `head_width`."""
    C, hc, cv = cfg["channels"], cfg["head_channels"], cfg["c_val"]
    k = cfg["conv_size"] + 2
    trunk = trunk_module(cfg, bench_dir)
    flops = 2 * POINTS * 15 * C * k * k + 2 * 8 * C + trunk.flops(cfg)
    H = trunk.head_width(cfg)
    # Policy: conv_p, conv_g, the pooled bias, the move and pass logits.
    flops += 2 * (2 * POINTS * H * hc) + 2 * 2 * hc * hc + 2 * POINTS * hc + 2 * 2 * hc
    # Value: conv, outcome embedding and outputs, gamma, the score head over
    # its 800 bins.
    flops += 2 * POINTS * H * hc + 2 * 2 * hc * cv + 2 * cv * 14
    flops += 2 * 2 * hc * cv + 2 * cv + 2 * 2 * hc * cv + 800 * 2 * cv
    return float(flops)
