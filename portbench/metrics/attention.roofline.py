"""attention.roofline: the attention core's share of its bound over the
profiled plies. The bound is `work.bound_s` of the operations and bytes
of every `trunk.attention` span placed on the profile
(`harness/attention_work.py`: 4 N H T^2 D operations; q, k, v and the
output once each in bf16, 8 N T H D bytes, from the span's attributes),
over the device time of the kernels launched inside those spans (as
`attention.device_ms_per_ply` reads it). None where the program opens no
such span."""
from portbench.harness.attention_work import SPAN, placed_work
from portbench.harness.program_spans import overlay
from portbench.harness.work import bound_s


def read(rec):
    ov = overlay(rec)
    if ov is None:
        return None
    ns, launched, found = ov.launched_kernel_ns(SPAN)
    flops, nbytes, spans = placed_work(ov)
    if found == 0 or spans == 0 or ns <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes) / (ns / 1e9)
