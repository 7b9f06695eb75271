"""Program spans: one process-wide, bounded store of timed host regions,
recorded only while a ``torch.profiler`` records in the process.

A span is ``(name, t_start, t_end, thread, parent, job)``, its times
``time.monotonic()`` seconds (the clock of the engine's ``perf_counter``
stamps and, less its epoch, of ``RealClock``); ``parent`` is the name of
the enclosing span on the same thread, ``job`` the worker's job id where
the region serves one job.

``span(name, job=...)`` times a synchronous region and ``spans(a, b)``
returns the records that overlap a window. The gate is the profiler's
process-wide flag (``torch.autograd.profiler._is_profiler_enabled``): off,
``span`` returns one shared no-op context. On, a span also enters
``record_function("infaas.<name>")`` on the thread whose profiler records
(the profiler sees host events of that thread alone), so the device
trace's idle gaps are named by the host's regions.

Spans mark host work only. The profiler projects a ``record_function``
range that launches device work onto the device's timeline, from its
first kernel to its last, and a reader of the device's intervals would
count that range as busy; so no span encloses a prefill, a decode segment
or a step.

It sits at the package's top and imports only ``torch``, beside the
engine and the executors that record into it (``serving``'s package
imports ``core.worker``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16          # records kept; the oldest go first


class Span(NamedTuple):
    name: str
    t_start: float
    t_end: float
    thread: str
    parent: Optional[str]
    job: Optional[int]


_store: Deque[Span] = deque(maxlen=CAPACITY)
_local = threading.local()


def _stack() -> List["_Open"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The context of every span while no profiler records."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "job", "t_start", "parent", "rf")

    def __init__(self, name: str, job: Optional[int]):
        self.name, self.job, self.rf = name, job, None

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        if torch._C._autograd._profiler_enabled():
            self.rf = _profiler.record_function("infaas." + self.name)
            self.rf.__enter__()
        self.t_start = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t_end = time.monotonic()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        _store.append(Span(self.name, self.t_start, t_end,
                           threading.current_thread().name, self.parent,
                           self.job))
        return False


def span(name: str, job: Optional[int] = None):
    """A context timing the host region ``name`` (of the worker's job
    ``job``, where it serves one)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, job)


def spans(t_a: float = float("-inf"),
          t_b: float = float("inf")) -> List[Span]:
    """The stored spans that overlap ``[t_a, t_b]``, in the order they
    ended."""
    return [s for s in tuple(_store) if s.t_end >= t_a and s.t_start <= t_b]
