"""step.kernels_per_ply: CUDA kernels that ran a ply over the profiled
plies: the device kernel records, whether a kernel was launched alone or
in a CUDA graph, plus one for each kernel launch record of the runtime
whose device record CUPTI dropped (`trace.Profile.kernel_count`)."""


def read(rec):
    p = rec.profile
    if p is None or p.plies == 0 or not (p.kernels or p.launches):
        return None
    return p.kernel_count() / p.plies
