"""search.sync_wait_ms_per_ply: host ms a profiled ply spent blocked in the
search's own syncs, all causes: `mcts.gumbel.COUNTERS.sync_wait_ns`, which
the program fills while its tracer is on (the profiled plies), over those
plies."""
from portbench.harness.program_spans import records, sync_wait_ns


def read(rec):
    p = rec.profile
    if p is None or p.plies == 0 or not records():
        return None
    ns = sync_wait_ns()
    return None if ns is None else ns / p.plies / 1e6
