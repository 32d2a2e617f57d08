"""search.backup.idle_ms_per_ply: device-idle ms a ply, over the profiled
plies, while the innermost program span open on the host is
`search.backup` (a sweep's backup, `gumbel._backup`): the program's spans
laid over the profile by `harness/program_spans.py`."""
from portbench.harness.program_spans import overlay


def read(rec):
    ov = overlay(rec)
    if ov is None or rec.profile.plies == 0:
        return None
    return ov.idle_by_span().get("search.backup", 0.0) * 1e3 / rec.profile.plies
