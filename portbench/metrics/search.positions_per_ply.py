"""search.positions_per_ply: positions the searches gave the eval function a
profiled ply: the rows of the program's `search.eval` spans, one a call of
the eval function by a search, over the profiled plies."""
from portbench.harness.program_spans import records


def read(rec):
    p = rec.profile
    spans = records()
    if p is None or p.plies == 0 or not spans:
        return None
    return sum(s.attrs["rows"] for s in spans if s.name == "search.eval") / p.plies
