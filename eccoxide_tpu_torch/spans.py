"""Spans inside the port's host entries and verifier cores: named
intervals on the host's clock, nested per thread, with counts taken at
their boundaries. Off by default, and then free of any work beyond one
check of a module flag.

An operator who wants to see where a call's time goes:

    from eccoxide_tpu_torch import spans
    spans.enable()
    ok = ed25519.verify_host(pks, msgs, sigs)
    for r in spans.drain():
        print(r.name, (r.end_ns - r.start_ns) / 1e6, "ms", r.fields)
    spans.disable()

Each record is ``(id, parent, root, name, start_ns, end_ns, fields)``:
``parent`` is the enclosing span's id (None at a root), ``root`` the id of
the outermost span of the same call, so the spans of one entry call share
it. Times are ``time.perf_counter_ns()``. A span around device work
measures the host's issue of that work: nothing here synchronizes the
device. While on, every span also enters
``torch.profiler.record_function(name)``, so a running profiler shows it
on the host timeline; adding ``trace_offset_ns()`` to a record's times
puts them on the profiler's clock (Unix ns). The newest 2^20 records are
kept.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

MAX_RECORDS = 1 << 20


class Record(NamedTuple):
    id: int
    parent: int | None
    root: int
    name: str
    start_ns: int
    end_ns: int
    fields: dict


_on = False
_offset_ns = 0
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span while recording is off: one shared object that does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **fields):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "fields", "id", "parent", "root", "start_ns", "_rf")

    def __init__(self, name: str):
        self.name, self.fields = name, {}

    def set(self, **fields):
        """Counts taken at this span's boundary, kept with its record."""
        self.fields.update(fields)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        _local.stack.pop()
        rec = Record(self.id, self.parent, self.root, self.name, self.start_ns, end_ns,
                     self.fields)
        with _lock:
            _records.append(rec)
        return False


def span(name: str):
    """A context manager for the span ``name``; ``with span(n) as s:``
    gives an object whose ``s.set(**fields)`` keeps counts with the
    record. Off, the shared no-op ``OFF``."""
    if not _on:
        return OFF
    return _Span(name)


def enable():
    """Record spans from now on, in every thread, and take the offset from
    ``perf_counter_ns`` to Unix ns (``trace_offset_ns``)."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable():
    """Stop recording; spans open now still record when they close."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> list[Record]:
    """The records kept so far, oldest first (a span is recorded when it
    closes, so children come before their parent), and none kept after."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out


def trace_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()`` at the last ``enable()``:
    added to a record's times, the Unix ns of torch.profiler's events."""
    return _offset_ns
