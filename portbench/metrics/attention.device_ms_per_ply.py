"""attention.device_ms_per_ply: device time a ply of the kernels launched
inside the program's `trunk.attention` spans (a transformer block's
q.k^T, softmax and weights.v; the projections are outside), directly or
by a CUDA graph launched there, over the profiled plies; scaled by the
launches over those with a device record where CUPTI dropped some. The
spans are laid over the profile by `harness/program_spans.py`. None
where the program opens no such span."""
from portbench.harness.attention_work import SPAN
from portbench.harness.program_spans import overlay


def read(rec):
    ov = overlay(rec)
    if ov is None or rec.profile.plies == 0:
        return None
    ns, launched, found = ov.launched_kernel_ns(SPAN)
    if found == 0:
        return None
    return ns / rec.profile.plies / 1e6
