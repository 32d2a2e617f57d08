"""trunk_broadcast.roofline: the broadcast block's share of its bound over
the profiled plies. Operations and bytes of each call from its shapes
(`work.broadcast_work`: boards, C, noted by the harness's wrapper of
`ops.trunk.trunk_broadcast`). A call launches one kernel of each
`trunk_broadcast` name once (three at C = 256 / 384: first, mix, last), so
a call's time is the sum over names of each name's mean recorded time, and
the calls' time that times the wrapper's calls (CUPTI drops records)."""
from portbench.harness.work import bound_s, broadcast_work


def read(rec):
    if rec.profile is None:
        return None
    calls = [c for c in rec.calls.get("trunk_broadcast", []) if c[0] > 0]
    kern = rec.profile.kernel_time(lambda name: "trunk_broadcast" in name)
    if not calls or not kern:
        return None
    per_call_ns = sum(m for _, m in kern.values())
    bound = sum(bound_s(*broadcast_work(*c)) for c in calls)
    return 100.0 * bound / (per_call_ns * len(calls) / 1e9)
