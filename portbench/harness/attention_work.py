"""The attention core's work from the program's `trunk.attention` spans.

Each span (p3achygo_tpu_torch/models/transformer.py) holds one block's
q.k^T, softmax and weights.v over `rows` boards of `tokens` tokens, in
`heads` heads of `head_dim`, and carries those four numbers. The count is
what any implementation of that core has to do, so that a fused kernel
moves the roofline without a change to it: the two products' operations
(2 a multiply-add) and q, k and v read and the output written once each
in bf16. The scores are not counted: a fused kernel never writes them.
"""
from __future__ import annotations

from typing import Tuple

from portbench.harness.work import BF16

SPAN = "trunk.attention"


def attention_work(rows: int, tokens: int, heads: int, head_dim: int) -> Tuple[float, float]:
    """(operations, bytes) of one span's attention core."""
    flops = 4 * rows * heads * tokens * tokens * head_dim
    nbytes = 4 * rows * tokens * heads * head_dim * BF16
    return float(flops), float(nbytes)


def placed_work(ov) -> Tuple[float, float, int]:
    """(operations, bytes, spans) summed over the `trunk.attention` spans
    that the overlay `ov` (`program_spans.Overlay`) placed on the profile's
    clock: the spans whose kernels `launched_kernel_ns` times."""
    flops = nbytes = 0.0
    n = 0
    for s, m in zip(ov.spans, ov.mapped):
        if s.name == SPAN and m is not None:
            f, b = attention_work(s.attrs["rows"], s.attrs["tokens"], s.attrs["heads"],
                                  s.attrs["head_dim"])
            flops, nbytes, n = flops + f, nbytes + b, n + 1
    return flops, nbytes, n
