"""trunk_segment.roofline: the segment kernel's share of its bound over the
profiled plies. Operations and bytes of each call from its shapes
(`work.segment_work`: boards, blocks, layers, C, Cb, noted by the harness's
wrapper of `ops.trunk.trunk_segment`); kernel time = the mean recorded
`trunk_segment` kernel time times the wrapper's calls (one kernel a call;
CUPTI drops records)."""
from portbench.harness.work import bound_s, segment_work


def read(rec):
    if rec.profile is None:
        return None
    calls = [c for c in rec.calls.get("trunk_segment", []) if c[0] > 0]
    kern = rec.profile.kernel_time(lambda name: "trunk_segment" in name)
    if not calls or not kern:
        return None
    n = sum(r for r, _ in kern.values())
    mean_ns = sum(r * m for r, m in kern.values()) / n
    bound = sum(bound_s(*segment_work(*c)) for c in calls)
    return 100.0 * bound / (mean_ns * len(calls) / 1e9)
