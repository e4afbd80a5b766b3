"""The port's tracer: spans and their counts at the layer boundaries of the
pathology path, recorded in memory while :func:`recording` is entered and
while ``torch.profiler`` is on, so that a profile of the port holds the
host's spans on the profiler's own clock.

A span has a name, a layer, a start and an end on :func:`now_ns`'s clock,
its own id, its parent's id (the span that caused it), the id of its study
(the root span: every span of one entry call shares it), the host thread,
and counts as attributes. A span's parent is the innermost span open on its
thread, or the one handed to it: the Manager's worker threads take theirs
from the work item (``WorkItem.parent_span``), which ``execute_study`` stamps
with its caller's span.

``now_ns`` is the clock that ``torch.profiler`` stamps its events with, so
an idle gap of the device can be matched with the spans the host had open.
No span waits for the device: a span around a launch ends when the launch
returns. Off (the default), a boundary costs a test of two module flags,
this module's and the profiler's.

    from repro_torch import trace
    with trace.recording():
        run_dataset_study(...)
    for sp in trace.records():
        print(sp.name, sp.layer, sp.end_ns - sp.start_ns, sp.attrs)
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from torch.autograd import profiler as _profiler

__all__ = ["ON", "Span", "recording", "active", "span", "record", "current", "count", "now_ns",
           "records"]

now_ns = time.time_ns  # the host clock torch.profiler's (kineto's) events are stamped on

ON = False  # set by recording(); the boundaries also record while the profiler is on
_records: List["Span"] = []  # list.append is atomic; cleared only on entry to recording()
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans, innermost last


class Span:
    """One finished (or open) span; ``parent`` and ``study`` are span ids,
    ``parent`` 0 at a root."""

    __slots__ = ("name", "layer", "start_ns", "end_ns", "id", "parent", "study", "thread",
                 "attrs")

    def __init__(self, name: str, layer: str, parent: Optional["Span"],
                 attrs: Dict[str, Any]) -> None:
        self.name, self.layer, self.attrs = name, layer, attrs
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else 0
        self.study = parent.study if parent is not None else self.id
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = 0

    def count(self, **counts: int) -> None:
        """Adds ``counts`` to the span's attributes."""
        for k, v in counts.items():
            self.attrs[k] = self.attrs.get(k, 0) + v

    def __enter__(self) -> "Span":
        _stack().append(self)
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = now_ns()
        _stack().pop()
        _records.append(self)


class _Off:
    """What a boundary gets while tracing is off: does nothing."""

    def count(self, **counts: int) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turns tracing on. Entry drops the records of an earlier recording;
    the new ones stay readable after exit, until the next entry."""
    global ON
    _records.clear()
    ON = True
    try:
        yield
    finally:
        ON = False


def active() -> bool:
    """Whether the boundaries record: inside :func:`recording`, or while
    ``torch.profiler`` is on (its records stay until the next entry to
    :func:`recording`)."""
    return ON or _profiler._is_profiler_enabled


def span(name: str, layer: str, parent: Optional[Span] = None, **attrs: Any):
    """A context manager that records one span; its parent is ``parent``
    where given (a span of another thread), else the innermost span open on
    this thread."""
    if not (ON or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, layer, parent if parent is not None else current(), attrs)


def record(name: str, layer: str, start_ns: int, end_ns: int, parent: Optional[Span],
           **attrs: Any) -> None:
    """Records a span that has already ended (one whose two ends are seen on
    different threads)."""
    if not (ON or _profiler._is_profiler_enabled):
        return
    sp = Span(name, layer, parent, attrs)
    sp.start_ns, sp.end_ns = start_ns, end_ns
    _records.append(sp)


def current() -> Optional[Span]:
    """The innermost span open on this thread, ``None`` where there is
    none or nothing records."""
    if not (ON or _profiler._is_profiler_enabled):
        return None
    stack = _stack()
    return stack[-1] if stack else None


def count(**counts: int) -> None:
    """Adds ``counts`` to the innermost span open on this thread."""
    if not (ON or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        stack[-1].count(**counts)


def records() -> List[Span]:
    """The spans finished since the last entry to :func:`recording`, those
    recorded under the profiler included."""
    return list(_records)
