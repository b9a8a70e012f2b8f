"""Spans of the port's work, recorded while a torch.profiler session
records and free otherwise.

    with tracing.span("forward"):
        ...

With no profiler recording, `span` returns one shared no-op context: the
cost is one flag check. Inside a profiler session (the benchmark's
`--trace 1` window, or a run under `cli --profile-dir`) a span is
`torch.profiler.record_function("nvsr." + name)`, a `user_annotation`
event of the profiler's own trace, on the clock of the device's kernels;
and it appends a record to this module's list:

* `name`, `args` (the keyword arguments, plus what `set` adds later);
* `parent`: the list index of the innermost span open at its entry, or
  None;
* `iteration`: the `iteration` arg of its root (the outermost open span),
  shared by every span of one training iteration;
* `start_ns`, `end_ns`: `time.time_ns()` at entry and exit, the clock the
  trace's `ts + baseTimeNanoseconds / 1e3` is on;
* `ms`: on the CPU the host duration; once CUDA is initialized, the time
  between two timing events recorded on the current stream at entry and
  exit, filled in by `records()`. Nothing is synchronized and no event
  is read while the profiler records.

The profiler's Chrome trace keeps a span's name and interval, not its
args: the args are in the record alone. The list holds at most CAP
records and counts the spans it drops, so a long profiled run cannot
grow it without bound. Call `clear()` between sessions, outside any
span.
"""

from __future__ import annotations

import time

import torch

PREFIX = "nvsr."
CAP = 65_536

_records: list = []
_open: list = []          # the open spans' records, innermost last
_dropped = 0


class _Noop:
    """The span outside a profiler session."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass


# the shared no-op span (also for a `with` whose span is conditional)
NO_SPAN = _Noop()


class _Span:
    __slots__ = ("_rec", "_fn", "_events")

    def __init__(self, name: str, args: dict):
        self._rec = {"name": name, "args": args}

    def set(self, **args):
        """Add args to the span's record (e.g. what the span learns after
        its entry)."""
        self._rec["args"].update(args)

    def __enter__(self):
        global _dropped
        rec = self._rec
        self._fn = torch.profiler.record_function(PREFIX + rec["name"])
        self._fn.__enter__()
        outer = _open[-1] if _open else None
        if outer is None:
            rec["parent"] = None
            rec["iteration"] = rec["args"].get("iteration")
        else:
            rec["parent"] = outer.get("index")
            rec["iteration"] = outer["iteration"]
        if len(_records) < CAP:
            rec["index"] = len(_records)
            _records.append(rec)
        else:
            _dropped += 1
        _open.append(rec)
        self._events = None
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        rec["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if self._events is not None:
            self._events[1].record()
            rec["_events"] = self._events
        rec["end_ns"] = time.time_ns()
        if self._events is None:
            rec["ms"] = (rec["end_ns"] - rec["start_ns"]) * 1e-6
        _open.pop()
        self._fn.__exit__(*exc)
        return False


def span(name: str, **args):
    """A context that records `name` while a profiler records, else the
    shared no-op. Both have `set(**args)`."""
    if not torch._C._autograd._profiler_enabled():
        return NO_SPAN
    return _Span(name, args)


def records() -> list:
    """The records, each closed one with its `ms`: the device-stream
    milliseconds between its timing events, read after one synchronize,
    or its host duration. Idempotent."""
    pending = [r for r in _records if "_events" in r]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            start, end = r.pop("_events")
            r["ms"] = start.elapsed_time(end)
    return _records


def dropped() -> int:
    """How many spans the cap kept out of the list."""
    return _dropped


def clear():
    """Empty the list and the count of dropped spans."""
    global _dropped
    _records.clear()
    _dropped = 0
