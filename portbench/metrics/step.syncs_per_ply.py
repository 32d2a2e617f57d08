"""step.syncs_per_ply: every device-to-host sync a profiled ply made, wherever
it is (`.item()`, `bool()`, `nonzero`, a boolean-mask index, a blocking
copy), as the card reports them to the program's tracer, which counts each
under the innermost span open (`tracing.Span.syncs`), over the profiled
plies."""
from portbench.harness.program_spans import outside_syncs, records


def read(rec):
    p = rec.profile
    spans = records()
    if p is None or p.plies == 0 or not spans:
        return None
    return (sum(s.syncs for s in spans) + outside_syncs()) / p.plies
