"""device.idle_share: 100 * (1 - the union of device operation intervals
(kernels, copies, fills) over the profiled plies' span)."""


def read(rec):
    p = rec.profile
    if p is None or p.span_s <= 0 or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.span_s)
