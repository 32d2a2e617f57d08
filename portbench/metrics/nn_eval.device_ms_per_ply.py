"""nn_eval.device_ms_per_ply: device time a ply of the kernels launched
inside the `nn_eval` range the harness opens around the eval function it
builds (featurizer, symmetry, forward, reductions), directly or by a CUDA
graph launched there, over the profiled plies; scaled by the range's
launches over those with a device record where CUPTI dropped some."""


def read(rec):
    p = rec.profile
    if p is None or p.plies == 0:
        return None
    ns, launched, found = p.range_kernel_ns("nn_eval")
    if found == 0:
        return None
    return ns / p.plies / 1e6
