"""Spans and host syncs inside the self-play ply.

    from p3achygo_tpu_torch import tracing
    with tracing.span("search.backup"):
        ...

The tracer is off by default. Off, `span()` tests one module flag and
returns a shared null context: no allocation, no torch call. `enable()` /
`disable()` turn it on and off. Besides, a ply opened by `ply()` (the
self-play step and the reset) while a torch profiler session runs is
traced, and only that ply, so a profile of the program always carries its
ranges (and runs that ply with the sync-debug mode below) and an untraced
run pays one flag read a ply.

While on, each span
- records its name, its start and end (`time.perf_counter_ns`, read just
  outside the profiler range below), the index
  of its parent span, its ply (an id shared by every span under one
  top-level span) and a few small attributes;
- opens `torch.profiler.record_function(name)`, so that a profile shows it
  as a `user_annotation` range on the clock of the device records;
- counts the host syncs made while it is the innermost open span
  (`Span.syncs`): on a CUDA card, every synchronizing operation that
  `torch.cuda.set_sync_debug_mode("warn")` reports, such as `item()`,
  `bool()`, `nonzero`, a boolean-mask index or a blocking copy.

Records stay in memory (`spans()`) until `reset()`; `summary()` gives
count, total and self seconds and syncs by span name. Names are dotted
(`search.descent`), so none equals a one-word range that code around the
program opens. One thread opens spans at a time.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

SYNC_MESSAGE = "synchronizing CUDA operation"

_on = False  # the flag span() tests
_explicit = False  # enable() was called
_records: List["Span"] = []
_stack: List[int] = []  # indices of the open spans, innermost last
_next_ply = 0
_outside_syncs = 0  # syncs while on with no span open
_restore = None  # what _start() changed, for _stop()


class Span:
    """One span's record; `end` is None while it is open."""

    __slots__ = ("name", "start", "end", "parent", "ply", "attrs", "syncs")

    def __init__(self, name: str, start: int, parent: int, ply: int, attrs: dict):
        self.name, self.start, self.end = name, start, None
        self.parent, self.ply, self.attrs, self.syncs = parent, ply, attrs, 0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, start={self.start}, end={self.end}, "
                f"parent={self.parent}, ply={self.ply}, attrs={self.attrs}, "
                f"syncs={self.syncs})")


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _Null()


class _Open:
    """A span being recorded. `set(**attrs)` adds attributes known only
    once its work has run. With `follow`, tracing was started for this
    ply alone and stops when it closes."""

    __slots__ = ("name", "attrs", "span", "range", "follow")

    def __init__(self, name: str, attrs: dict, follow: bool = False):
        self.name, self.attrs, self.follow = name, attrs, follow

    def __enter__(self):
        global _next_ply
        if self.follow:
            _start()
        # The clock readings enclose the profiler range.
        start = time.perf_counter_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        parent = _stack[-1] if _stack else -1
        if parent < 0:
            ply, _next_ply = _next_ply, _next_ply + 1
        else:
            ply = _records[parent].ply
        self.span = Span(self.name, start, parent, ply, self.attrs)
        _stack.append(len(_records))
        _records.append(self.span)
        return self

    def __exit__(self, *exc):
        _stack.pop()
        self.range.__exit__(*exc)
        self.span.end = time.perf_counter_ns()
        if self.follow:
            _stop()
        return False

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager that records the span `name` while tracing is on."""
    if not _on:
        return _NULL
    return _Open(name, attrs)


def ply(name: str, **attrs):
    """`span(name)` for the top-level span of a ply. It is also recorded,
    with everything under it, when the tracer is off but a torch profiler
    session runs as the ply starts."""
    if _on:
        return _Open(name, attrs)
    if not _profiling():
        return _NULL
    return _Open(name, attrs, follow=True)


def _profiling() -> bool:
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    return bool(flag) if flag is not None else torch.autograd._profiler_enabled()


def is_on() -> bool:
    return _on


def enable() -> None:
    """Record spans and syncs until `disable()`."""
    global _explicit
    _explicit = True
    _start()


def disable() -> None:
    global _explicit
    _explicit = False
    _stop()


def _count_sync() -> None:
    global _outside_syncs
    if _stack:
        _records[_stack[-1]].syncs += 1
    else:
        _outside_syncs += 1


def _start() -> None:
    """Tracing on: the flag, and every sync the card reports counted."""
    global _on, _restore
    if _on:
        return
    catch = warnings.catch_warnings()
    catch.__enter__()
    warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            _count_sync()
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _restore = (catch, mode)
    _on = True


def _stop() -> None:
    global _on, _restore
    if not _on or _explicit:
        return
    catch, mode = _restore
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    catch.__exit__(None, None, None)
    _restore = None
    _on = False


def spans() -> List[Span]:
    """The records kept since the last `reset()`, in the order opened."""
    return list(_records)


def outside_syncs() -> int:
    """Syncs counted while tracing was on and no span was open."""
    return _outside_syncs


def reset() -> None:
    """Drop the records and sync counts (no span may be open)."""
    global _outside_syncs
    if _stack:
        raise RuntimeError(f"tracing.reset() with {len(_stack)} span(s) open")
    _records.clear()
    _outside_syncs = 0


def summary() -> Dict[str, dict]:
    """{span name: {count, total_s, self_s, syncs}} over the closed spans
    kept. A span's self time is its duration less its children's."""
    children = [0] * len(_records)
    for sp in _records:
        if sp.end is not None and sp.parent >= 0:
            children[sp.parent] += sp.end - sp.start
    out: Dict[str, dict] = {}
    for sp, child_ns in zip(_records, children):
        if sp.end is None:
            continue
        d = out.setdefault(sp.name, {"count": 0, "total_s": 0.0, "self_s": 0.0, "syncs": 0})
        d["count"] += 1
        d["total_s"] += (sp.end - sp.start) / 1e9
        d["self_s"] += (sp.end - sp.start - child_ns) / 1e9
        d["syncs"] += sp.syncs
    return out
