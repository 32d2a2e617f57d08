"""The program's own spans laid over a profile of whole plies, for the
per-layer readers under metrics/ that read inside the ply.

The program records its spans itself (`p3achygo_tpu_torch.tracing`): a
ply that starts while a torch profiler runs is traced, so the profiled
plies of a traced run carry them and the timed window does not. A span's
start and end are `time.perf_counter_ns` readings; the profile's records
are on the profiler's clock. `trace.Profile` keeps only the harness's own
ranges, so the two are laid over each other here by those ranges, ply by
ply: the harness's `step`, `reset` and `search` ranges each enclose one
program span (`selfplay.step`, `selfplay.reset`, `search.root`), and each
program `search.eval` encloses one harness `nn_eval` range. Every such
pair bounds the offset between the clocks from both sides. Where the
bounds of all plies agree, one offset, the middle of their intersection,
places every span; where they do not (the clocks drifted apart), each ply
takes the middle of its own. The width of the bounds used (logged) is the
most any span edge can be misplaced.

With the spans on the profile's clock:
- idle by span: each stretch of the profiled plies' span in which no
  device operation ran (the complement of `Profile.busy_intervals`) is
  split by the innermost program span open on the host over it; what no
  span covers is `NONE`. The parts add up to the idle time that
  `device.idle_share` reads;
- kernels launched inside a span: as `Profile.range_kernel_ns`, with the
  program's spans in place of a harness range.

A program without the tracer, or a profile without its spans, gives None.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

NONE = "(no program span)"
# (harness range, program span, True where the harness range encloses it).
PAIRS = (("step", "selfplay.step", True), ("reset", "selfplay.reset", True),
         ("search", "search.root", True), ("nn_eval", "search.eval", False))
_cache: list = []  # [(profile, Overlay or None)] of the last profile read


def records() -> Optional[list]:
    """The program's span records, or None where the program has no tracer."""
    try:
        from p3achygo_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def sync_wait_ns() -> Optional[int]:
    """Host ns the search's own syncs blocked while the tracer was on, all
    causes (`gumbel.COUNTERS.sync_wait_ns`), or None where it has none."""
    from p3achygo_tpu_torch.mcts import gumbel

    waits = getattr(gumbel.COUNTERS, "sync_wait_ns", None)
    if waits is None:
        return None
    return sum(waits.values())


def outside_syncs() -> int:
    from p3achygo_tpu_torch import tracing

    return tracing.outside_syncs()


class Overlay:
    """The program spans `spans` (tracing.Span records) of the profile `p`
    on its clock: `mapped[i]` = (start, end) in profile ns of spans[i]
    (None for a span of a ply no pair placed)."""

    def __init__(self, p, spans: list):
        self.profile, self.spans = p, spans
        self.bounds = self._bounds()
        lo = max((b[0] for b in self.bounds.values()), default=0.0)
        hi = min((b[1] for b in self.bounds.values()), default=0.0)
        # One offset where every ply's bounds agree, else each ply's own.
        self.used = ({ply: (lo, hi) for ply in self.bounds} if lo <= hi else self.bounds)
        self.offset = {ply: (a + b) / 2 for ply, (a, b) in self.used.items()}
        self.mapped: List[Optional[Tuple[int, int]]] = []
        for s in spans:
            d = self.offset.get(s.ply)
            self.mapped.append(None if d is None or s.end is None
                               else (int(round(s.start + d)), int(round(s.end + d))))
        self.plies = sorted({s.ply for s in spans if s.parent < 0 and s.ply in self.offset})
        self.timeline = self._timeline()

    def _bounds(self) -> Dict[int, Tuple[float, float]]:
        """{ply: (lower, upper)} bounds of the offset profile ns - program
        ns, from each harness range paired with the program span it
        encloses or that encloses it (the k-th range of a name with the
        k-th span of its partner's name)."""
        lo: Dict[int, float] = defaultdict(lambda: float("-inf"))
        hi: Dict[int, float] = defaultdict(lambda: float("inf"))
        for h_name, s_name, outer in PAIRS:
            ranges = sorted((s, e) for n, s, e in self.profile.ranges if n == h_name)
            mine = [s for s in self.spans if s.name == s_name and s.end is not None]
            if len(ranges) != len(mine):
                continue
            for (h0, h1), s in zip(ranges, mine):
                a, b = h0 - s.start, h1 - s.end
                if outer:  # h0 <= start + d, end + d <= h1
                    lo[s.ply], hi[s.ply] = max(lo[s.ply], a), min(hi[s.ply], b)
                else:  # start + d <= h0, h1 <= end + d
                    lo[s.ply], hi[s.ply] = max(lo[s.ply], b), min(hi[s.ply], a)
        return {ply: (lo[ply], hi[ply]) for ply in set(lo) | set(hi)
                if lo[ply] > float("-inf") and hi[ply] < float("inf")}

    def width_ns(self) -> float:
        """The widest offset bracket used (negative: a ply's own pairs
        disagree by that much, and the middle is taken)."""
        return max((h - l for l, h in self.used.values()), default=float("nan"))

    def _timeline(self) -> List[Tuple[int, int, str]]:
        """[(start, end, name)] in profile ns: the stretches in which the
        span `name` is the innermost open one, in order."""
        children = defaultdict(list)
        for i, s in enumerate(self.spans):
            if s.parent >= 0 and self.mapped[i] is not None:
                children[s.parent].append(i)
        out: List[Tuple[int, int, str]] = []

        def walk(i):
            t, end = self.mapped[i]
            for c in sorted(children[i], key=lambda c: self.mapped[c][0]):
                c0, c1 = self.mapped[c]
                if c0 > t:
                    out.append((t, c0, self.spans[i].name))
                walk(c)
                t = max(t, c1)
            if end > t:
                out.append((t, end, self.spans[i].name))

        for i, s in enumerate(self.spans):
            if s.parent < 0 and self.mapped[i] is not None:
                walk(i)
        out.sort()
        clipped, t = [], None
        for s, e, name in out:  # plies placed by different offsets may touch
            s = s if t is None else max(s, t)
            if e > s:
                clipped.append((s, e, name))
                t = e
        return clipped

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.profile.span
        gaps, t = [], lo
        for s, e in self.profile.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def idle_by_span(self) -> Dict[str, float]:
        """Seconds of device idle time by the innermost program span open
        on the host, NONE where none is; they add up to the idle time."""
        out: Dict[str, float] = defaultdict(float)
        segs, j = self.timeline, 0
        for g0, g1 in self.idle_gaps():
            t = g0
            while j < len(segs) and segs[j][1] <= g0:
                j += 1
            k = j
            while t < g1:
                if k < len(segs) and segs[k][0] < g1:
                    s, e, name = segs[k]
                    if s > t:
                        out[NONE] += (min(s, g1) - t) / 1e9
                        t = min(s, g1)
                    if t < g1 and e > t:
                        out[name] += (min(e, g1) - t) / 1e9
                        t = min(e, g1)
                    k += 1
                else:
                    out[NONE] += (g1 - t) / 1e9
                    t = g1
        return dict(out)

    def launched_kernel_ns(self, name: str) -> Tuple[float, int, int]:
        """(device ns, launch records, launch records with a device record)
        of the kernels launched inside spans called `name`, directly or by a
        graph launched there; the time scaled up by the launches over the
        launches with a record found (dropped records)."""
        rs = sorted(m for s, m in zip(self.spans, self.mapped) if s.name == name and m)
        starts = [s for s, _ in rs]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < rs[i][1]

        p = self.profile
        launched = {corr for t, corr, _ in p.launches if inside(t)}
        ns = sum(e - s for _, s, e, corr, _ in p.kernels if corr in launched)
        found = len(launched & {k[3] for k in p.kernels})
        if found == 0:
            return 0.0, len(launched), 0
        return ns * len(launched) / found, len(launched), found


def overlay(rec, log=None) -> Optional[Overlay]:
    """The Overlay of `rec.profile` with the program's spans, made once a
    profile (the first call logs it); None where there is nothing to lay."""
    p = rec.profile
    if _cache and _cache[0][0] is p:
        return _cache[0][1]
    spans = records()
    ov = None
    if p is not None and p.device_ops and spans:
        ov = Overlay(p, spans)
        if not ov.plies:
            ov = None
    _cache[:] = [(p, ov)]
    if ov is not None:
        _log(ov, log or (lambda m: print(m, file=sys.stderr, flush=True)))
    return ov


def _log(ov: Overlay, log) -> None:
    idle = ov.idle_by_span()
    total = sum(idle.values())
    tops = {s.name for s in ov.spans if s.parent < 0}
    below = sum(v for k, v in idle.items() if k not in tops and k != NONE)
    syncs = defaultdict(int)
    for s in ov.spans:
        if s.ply in ov.offset:
            syncs[s.name] += s.syncs
    span_s = ov.profile.span_s
    one = len({b for b in ov.used.values()}) == 1
    log(f"program spans: {len(ov.spans)} spans in {len(ov.plies)} plies placed by "
        f"{'one offset' if one else 'an offset a ply'}, its bounds {ov.width_ns() / 1e3:.1f} us "
        f"wide (each ply's alone: {sorted(round((h - l) / 1e3, 1) for l, h in ov.bounds.values())}"
        f" us); idle {total:.6f} s "
        f"({100 * total / span_s:.3f}% of the span), {100 * below / max(total, 1e-12):.2f}% of it "
        f"under a span below {sorted(tops)}")
    log("idle by innermost program span: " + str(
        {k: round(v, 6) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}))
    log("syncs by program span: " + str(
        {k: v for k, v in sorted(syncs.items(), key=lambda kv: -kv[1]) if v}
        | ({"(none)": outside_syncs()} if outside_syncs() else {})))
