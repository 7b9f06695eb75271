"""Clock abstraction: the control plane is written against ``Clock`` so the
same code runs under a discrete-event virtual clock (cluster-scale
experiments) or wall time (real execution on host).

Both clocks implement the full scheduling surface (``schedule`` /
``schedule_at`` / ``every`` / ``next_event_time``): ``EventLoop`` fires
callbacks when a caller pumps ``step``/``run_until``, while ``RealClock``
fires them from a single daemon scheduler thread when wall time reaches the
deadline. Control-plane code that only ever runs from clock callbacks is
therefore single-threaded under either clock; the ``virtual`` attribute
tells blocking callers (``QueryHandle.result``) whether to pump the loop or
wait on a condition variable.
"""
from __future__ import annotations

import heapq
import itertools
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional, Tuple


class Clock:
    #: True when time only advances by pumping the loop (EventLoop); False
    #: when callbacks fire asynchronously as wall time passes (RealClock).
    virtual: bool = True

    def now(self) -> float:
        raise NotImplementedError

    def to_monotonic(self, t: float) -> float:
        """Clock time ``t`` on ``time.monotonic()``'s clock; -1.0 where
        the clock has none (virtual time)."""
        return -1.0

    def schedule_at(self, t: float, fn: Callable) -> None:
        raise NotImplementedError

    def schedule(self, delay: float, fn: Callable) -> None:
        self.schedule_at(self.now() + delay, fn)

    def every(self, period: float, fn: Callable, jitter: float = 0.0,
              stop: Optional[Callable[[], bool]] = None) -> None:
        """Fire ``fn`` every ``period + jitter`` seconds until ``stop()``.

        ``jitter`` applies to *every* interval (a fixed per-task phase
        offset), so two tasks with the same period but different jitter
        never collapse onto the same firing times.
        """
        def tick():
            if stop is not None and stop():
                return
            fn()
            self.schedule(period + jitter, tick)
        self.schedule(period + jitter, tick)

    def next_event_time(self) -> Optional[float]:
        raise NotImplementedError

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop firing events. No-op for the virtual clock (nothing runs
        between pumps); ``RealClock`` overrides to join its scheduler
        thread, so teardown code can call this on either clock."""


class RealClock(Clock):
    """Wall clock with a condition-variable timer thread.

    ``schedule``/``every`` callbacks fire on one daemon scheduler thread
    (started lazily on first use), in deadline order, with the internal
    lock *released* during each callback — callbacks may freely schedule
    more work. A callback that raises is reported to stderr and does not
    kill the scheduler.
    """

    virtual = False

    def __init__(self):
        self._t0 = time.monotonic()
        self._cv = threading.Condition()
        self._heap: List[Tuple[float, int, Callable]] = []
        self._counter = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def now(self) -> float:
        return time.monotonic() - self._t0

    def to_monotonic(self, t: float) -> float:
        return t + self._t0

    def schedule_at(self, t: float, fn: Callable) -> None:
        with self._cv:
            if self._stopped:
                return
            heapq.heappush(self._heap,
                           (max(t, self.now()), next(self._counter), fn))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="realclock-scheduler", daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def next_event_time(self) -> Optional[float]:
        with self._cv:
            return self._heap[0][0] if self._heap else None

    def pending(self) -> int:
        with self._cv:
            return len(self._heap)

    def run_until(self, t_end: float) -> None:
        """Block the calling thread until wall time ``t_end``; scheduled
        callbacks keep firing on the scheduler thread meanwhile."""
        while True:
            remaining = t_end - self.now()
            if remaining <= 0.0:
                return
            time.sleep(min(remaining, 0.05))

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop firing events and join the scheduler thread. Events still
        in the heap are dropped; subsequent ``schedule`` calls are no-ops."""
        with self._cv:
            self._stopped = True
            self._heap.clear()
            self._cv.notify_all()
            th = self._thread
        if th is not None and th.is_alive() \
                and th is not threading.current_thread():
            th.join(timeout)

    def _run(self) -> None:
        while True:
            fn = None
            with self._cv:
                if self._stopped:
                    return
                if not self._heap:
                    self._cv.wait()
                    continue
                delay = self._heap[0][0] - self.now()
                if delay > 0.0:
                    self._cv.wait(timeout=delay)
                    continue
                _, _, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:  # noqa: BLE001 - scheduler must survive
                print("RealClock callback raised:", file=sys.stderr)
                traceback.print_exc()


class EventLoop(Clock):
    """Deterministic discrete-event virtual clock.

    ``schedule(delay, fn)`` / ``schedule_at(t, fn)``; ``run_until(t)`` fires
    events in time order (FIFO for ties). Periodic tasks re-schedule
    themselves.
    """

    virtual = True

    def __init__(self):
        self._t = 0.0
        self._heap: List[Tuple[float, int, Callable]] = []
        self._counter = itertools.count()

    def now(self) -> float:
        return self._t

    def schedule_at(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._heap, (max(t, self._t), next(self._counter), fn))

    def next_event_time(self) -> Optional[float]:
        """Time of the earliest scheduled event, or None when drained
        (lets callers — e.g. ``QueryHandle.result`` — pump event-by-event
        without overshooting a deadline)."""
        return self._heap[0][0] if self._heap else None

    def step(self) -> bool:
        """Fire exactly the next scheduled event; False when drained."""
        if not self._heap:
            return False
        t, _, fn = heapq.heappop(self._heap)
        self._t = t
        fn()
        return True

    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._heap)
            self._t = t
            fn()
        self._t = max(self._t, t_end)

    def run_all(self, limit: int = 10_000_000) -> None:
        n = 0
        while self._heap and n < limit:
            t, _, fn = heapq.heappop(self._heap)
            self._t = t
            fn()
            n += 1
