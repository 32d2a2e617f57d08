"""liberties.roofline: the liberty kernel's share of its bound over the
profiled plies. Bytes of each call from its shape (`work.liberty_bytes`),
noted by the harness's wrapper of `ops.liberties.point_liberties_batch`;
kernel time = the mean recorded `point_liberties` kernel time times the
wrapper's calls that launched one (CUPTI drops records)."""
from portbench.harness.work import bound_s, liberty_bytes


def read(rec):
    if rec.profile is None:
        return None
    calls = [c for c in rec.calls.get("point_liberties_batch", []) if c[0] > 0]
    kern = rec.profile.kernel_time(lambda name: "point_liberties" in name)
    if not calls or not kern:
        return None
    n = sum(r for r, _ in kern.values())
    mean_ns = sum(r * m for r, m in kern.values()) / n
    bound = sum(bound_s(0.0, liberty_bytes(c[0])) for c in calls)
    return 100.0 * bound / (mean_ns * len(calls) / 1e9)
