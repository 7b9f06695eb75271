"""Deterministic fault injection for the serving stack.

Chaos testing is only useful when it is *reproducible*: a failure found
under injected faults must replay bit-for-bit so the fix can be verified.
``FaultInjector`` is that seam — one seeded object threaded through the
layers (engine executor, threaded stepper, worker daemons, master
dispatch), consulted at **named sites**:

======================  =====================================================
site                    where it fires / what it models
======================  =====================================================
``dispatch``            ``ThreadedEngineExecutor._admit_job`` raises before
                        submitting — a data-plane rejection the worker turns
                        into a failed query (master retry path).
``stepper``             the stepper thread's loop body raises — thread death.
                        The executor must fail in-flight jobs and restart
                        the thread, never wedge them.
``slow_step``           the stepper sleeps ``slow_step_s`` before a step —
                        a latency spike (GC pause, noisy neighbor).
``alloc``               engine-side admission/validation raises — an
                        allocation failure surfaced through ``on_done``.
``worker_hang``         ``Worker.monitor_tick`` calls ``self.hang()`` —
                        heartbeats stop, completions stall; the master's
                        failure sweep must notice and retry elsewhere.
``worker_crash``        ``Worker.monitor_tick`` calls ``self.fail()`` —
                        hard crash; in-flight queries fail through their
                        callbacks immediately.
======================  =====================================================

Two firing modes compose per site:

* **schedule** — fire exactly at the listed invocation counts (1-based):
  ``schedule={"stepper": [3, 7]}`` fires on the 3rd and 7th consult.
  Fully deterministic regardless of seed.
* **rate** — fire with probability ``p`` per consult, drawn from a seeded
  ``numpy`` generator: ``rates={"dispatch": 0.05}``. Deterministic for a
  fixed seed *and* consult order.

Sites not mentioned never fire. Per-site ``calls`` and ``fired`` counters
feed the chaos benchmark's fault accounting.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """An error raised on purpose by :class:`FaultInjector.check`."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site '{site}'")
        self.site = site


class FaultInjector:
    """Seeded, thread-safe fault oracle consulted at named sites."""

    def __init__(self, seed: int = 0,
                 schedule: Optional[Dict[str, Iterable[int]]] = None,
                 rates: Optional[Dict[str, float]] = None,
                 slow_step_s: float = 0.05):
        self._schedule = {site: frozenset(int(n) for n in ns)
                          for site, ns in (schedule or {}).items()}
        self._rates = dict(rates or {})
        self.slow_step_s = float(slow_step_s)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def fire(self, site: str) -> bool:
        """Consult the oracle: should ``site`` fail on this invocation?"""
        with self._lock:
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            hit = n in self._schedule.get(site, ())
            p = self._rates.get(site)
            if p is not None and not hit:
                # draw even when the schedule already decided, never —
                # the stream is consumed per *rated* consult only, so a
                # site's determinism doesn't depend on other sites' rates
                hit = bool(self._rng.random() < p)
            if hit:
                self.fired[site] = self.fired.get(site, 0) + 1
            return hit

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` when the oracle says so."""
        if self.fire(site):
            raise InjectedFault(site)

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Snapshot ``{site: {"calls": n, "fired": m}}`` for reporting."""
        with self._lock:
            sites = set(self.calls) | set(self.fired)
            return {s: {"calls": self.calls.get(s, 0),
                        "fired": self.fired.get(s, 0)} for s in sites}
