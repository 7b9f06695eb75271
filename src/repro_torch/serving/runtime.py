"""Wall-clock serving runtime: the INFaaS control plane as a live server
(the port of ``repro.serving.runtime``).

Under the virtual clock the control plane is a simulation harness — workers
resolve a job's service time synchronously (``Executor.run``) and advance
the ``EventLoop`` by that measured duration, and ``QueryHandle.result``
pumps the loop. This module supplies the two pieces that turn the same
control plane into a long-running server on ``RealClock``:

``ThreadedEngineExecutor``
    An ``EngineExecutor`` whose jobs run on a background *stepper thread*
    instead of blocking the caller: ``run_async(variant, batch, requests,
    on_done)`` enqueues the job and returns immediately; the stepper
    drives ``submit()/step()/drain_completions()`` continuously across all
    live engines, co-batching concurrent jobs that target the same
    variant, forwarding per-segment partial outputs to each query's
    ``on_tokens`` sink as they are harvested (time-to-first-token), and
    firing ``on_done(measured_service_time)`` when every request of a job
    has retired. The worker (``Worker._start_async``) marshals that
    completion back onto the clock's scheduler thread, so all control-
    plane state changes still happen one callback at a time.

``ServingRuntime``
    The client-facing wrapper over a wall-clock cluster: thread-safe
    ``submit`` (marshaled onto the scheduler thread, where the master's
    selection/dispatch runs like any other clock callback), bookkeeping of
    in-flight handles, and ``shutdown(drain=True)`` which waits for
    in-flight queries to stream out, stops the stepper threads, and stops
    the clock — the SIGINT path of ``launch/serve.py --clock wall``.

Thread model (three kinds of threads, one lock each):

    client threads ──submit()──► RealClock scheduler thread (control
        plane: master dispatch, worker bookkeeping, completions)
    scheduler thread ──run_async()──► stepper thread (data plane: engine
        step/drain; owns the executor lock)
    stepper thread ──on_tokens──► QueryHandle (handle condition variable;
        chunks stream without touching the control plane)
    stepper thread ──on_done──► loop.schedule(0, ...) ──► scheduler thread

On the card every stepper thread replays its engines' captured graphs
(decode segments and prefill dispatches) on the current stream; several
executors' stepper threads share one card. An engine that a job creates,
or a prompt bucket it has not seen, is captured on the stepper thread
(``ServingEngine.warmup``): captures are serialized across the process,
run in ``thread_local`` mode on a side stream, and their warm-up runs
leave the engine's pools and slot state as they were; each thread's
capture counts its launches apart (``kernels.build.capturing``). Warm
the service buckets before the first submit to keep captures out of a
serve. ``cancel_overdue`` (``deadline_enforce``) runs between steps, at
a segment's host boundary, never inside a replay.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.worker import ExecRequest
from repro_torch.serving.engine import Request
from repro_torch.serving.executor import EngineExecutor, EngineExecutorConfig


class _WallJob:
    """One ``run_async`` job in flight on the stepper thread."""
    __slots__ = ("variant", "batch", "eng", "groups", "on_done", "t0",
                 "occ", "outstanding", "synthetic")

    def __init__(self, variant, batch, eng, groups, on_done, t0, occ_keys):
        self.variant = variant
        self.batch = batch
        self.eng = eng
        self.groups: List[Tuple[ExecRequest, List[Request]]] = groups
        self.on_done = on_done
        self.t0 = t0
        # per-job occupancy accumulator: each engine step's stats delta
        # is split across the jobs co-batched on that engine by live-slot
        # share, so a job is billed only for its fraction of shared
        # segments (fractional, unlike the raw engine counters)
        self.occ: Dict[str, float] = {k: 0.0 for k in occ_keys}
        self.outstanding = sum(len(ers) for _, ers in groups)
        self.synthetic = not any(er.prompts for er, _ in groups)


class ThreadedEngineExecutor(EngineExecutor):
    """EngineExecutor stepped by a background thread (wall-clock mode).

    The synchronous ``run`` path is inherited unchanged (tests and the
    virtual clock keep using it); ``run_async`` is the non-blocking
    entry the worker prefers when present. One stepper thread per
    executor: jobs for the same variant co-batch on that variant's
    engine (continuous batching across control-plane jobs), jobs for
    different variants interleave step-by-step.
    """

    def __init__(self, arch_cfgs, cfg: EngineExecutorConfig =
                 EngineExecutorConfig(), model_cache=None, device="cuda"):
        # the LRU engine cap assumes engines are idle between run()
        # calls; a threaded executor's engines hold in-flight slots, so
        # eviction is disabled rather than risking a live engine
        if cfg.max_engines is not None:
            cfg = dataclasses.replace(cfg, max_engines=None)
        super().__init__(arch_cfgs, cfg, model_cache=model_cache,
                         device=device)
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._active: List[_WallJob] = []
        self._sinks: Dict[int, Tuple[ExecRequest, int]] = {}
        self._req_job: Dict[int, _WallJob] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        # chaos seam + crash accounting: the stepper consults the
        # injector at its named sites and survives its own death (see
        # _step_loop); jobs in flight at a crash FAIL (on_done(0.0, err))
        # rather than wedge, which is what routes them into the master's
        # retry path
        self._faults = cfg.faults
        self.stepper_restarts = 0

    # ------------------------------------------------------------------
    def run_async(self, variant, batch: int,
                  requests: Optional[List[ExecRequest]],
                  on_done: Callable[..., None]) -> None:
        """Enqueue one job for the stepper thread; returns immediately.
        ``on_done(duration_s)`` fires from the stepper thread when the
        job's last request retires; ``on_done(0.0, error)`` on rejection
        (e.g. a prompt exceeding the engine's max_len)."""
        if self._stopping:
            raise RuntimeError("executor is shutting down")
        self._queue.put((variant, batch, requests, on_done))
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._step_loop, name="engine-stepper", daemon=True)
            self._thread.start()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Drain: finish every queued/in-flight job, then stop the
        stepper thread. New ``run_async`` calls are rejected."""
        self._stopping = True
        self._queue.put(None)          # wake the stepper
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout)

    # ------------------------------------------------------------------
    def _admit_job(self, item: tuple) -> None:
        variant, batch, requests, on_done = item
        try:
            if self._faults is not None:
                self._faults.check("dispatch")
            with self._lock:
                eng = self._engine(variant)
                if self._faults is not None:
                    # models an allocation failure during admission: the
                    # engine exists but the job cannot be seated
                    self._faults.check("alloc")
                vocab = self.arch_cfgs[variant.arch].vocab
                if not requests:
                    requests = [ExecRequest(n_inputs=max(int(batch), 1))]
                real_lens = [len(p) for er in requests for p in er.prompts]
                if real_lens:
                    eng.warmup(prompt_lens=real_lens)
                t0 = time.perf_counter()
                groups: List[Tuple[ExecRequest, List[Request]]] = []
                for er in requests:
                    groups.append((er, self._make_requests(er, vocab, t0)))
                # validate everything before submitting anything, so a
                # rejected job never leaves half its prompts in the engine
                for _, ers in groups:
                    for r in ers:
                        eng._validate(r)
                job = _WallJob(variant, int(batch), eng, groups, on_done,
                               t0, self._OCC_KEYS)
                for er, ers in groups:
                    for i, r in enumerate(ers):
                        eng.submit(r)
                        self._sinks[id(r)] = (er, i)
                        self._req_job[id(r)] = job
                self._active.append(job)
        except Exception as e:  # noqa: BLE001 - reported through on_done
            on_done(0.0, e)

    def _finish_request(self, r: Request) -> None:
        job = self._req_job.pop(id(r), None)
        self._sinks.pop(id(r), None)
        if job is None:
            return
        job.outstanding -= 1
        if job.outstanding > 0:
            return
        dt = time.perf_counter() - job.t0
        self._active.remove(job)
        # co-batched jobs overlap on one engine; `job.occ` holds this
        # job's live-slot share of every shared segment (accumulated in
        # `_split_occupancy`), so the log entry bills each job its own
        # fraction instead of double-counting shared work
        self._record_occupancy_delta(job.variant, job.batch, dt, job.occ)
        for er, ers in job.groups:
            self._deliver(er, ers)
        if job.synthetic:
            n = max(sum(len(ers) for _, ers in job.groups), 1)
            self._observe(job.variant, n, dt)
        job.on_done(dt)

    def _step_loop(self) -> None:
        # Crash containment: any exception out of the stepping body —
        # including the injected "stepper" fault that models the thread
        # dying — fails every in-flight job through its on_done (the
        # worker turns that into a failed query; the master retries it on
        # the existing backoff path), drops the engines (their in-flight
        # slots are unrecoverable; model weights stay in the shared
        # cache; on the card their graphs and pools are freed once
        # collected, and a rebuilt engine captures anew), and restarts
        # the loop with clean state. Queued-but-
        # unadmitted jobs survive in self._queue and admit normally after
        # the restart. run_async's is_alive() check additionally respawns
        # the thread if it is ever truly gone.
        while True:
            try:
                self._run_steps()
                return              # clean shutdown drain
            except Exception as e:  # noqa: BLE001 - fail jobs, not wedge
                self._fail_inflight(e)
                if self._stopping:
                    return

    def _fail_inflight(self, err: Exception) -> None:
        with self._lock:
            jobs, self._active = list(self._active), []
            self._sinks.clear()
            self._req_job.clear()
            self.engines.clear()
            self.stepper_restarts += 1
        for job in jobs:
            try:
                job.on_done(0.0, err)
            except Exception:  # noqa: BLE001 - a sink must not re-kill us
                pass

    def _run_steps(self) -> None:
        while True:
            # pull new work: block briefly only when fully idle, so an
            # idle executor doesn't spin and a busy one doesn't stall
            block = not self._active
            try:
                item = self._queue.get(timeout=0.05) if block \
                    else self._queue.get_nowait()
                while item is not None:
                    self._admit_job(item)
                    item = self._queue.get_nowait()
            except queue.Empty:
                pass
            if not self._active:
                if self._stopping and self._queue.empty():
                    return
                continue
            if self._faults is not None:
                self._faults.check("stepper")    # → _step_loop restarts
                if self._faults.fire("slow_step"):
                    time.sleep(self._faults.slow_step_s)
            engines = []
            with self._lock:
                for job in self._active:
                    if job.eng not in engines:
                        engines.append(job.eng)
            for eng in engines:
                with self._lock:
                    if self.cfg.deadline_enforce:
                        eng.cancel_overdue()
                    if eng.busy:
                        occ0 = {k: eng.stats.get(k, 0)
                                for k in self._OCC_KEYS}
                        seated0 = {id(r) for r in eng._slot_req
                                   if r is not None}
                        eng.step()
                        self._pump_stream(eng, self._sinks)
                        self._split_occupancy(eng, occ0, seated0)
                    for r in eng.drain_completions():
                        self._finish_request(r)

    def _split_occupancy(self, eng, occ0: Dict[str, int],
                         seated0: set) -> None:
        """Attribute one step's stats delta to the jobs co-batched on
        ``eng``, each weighted by its live-slot share of the segment.

        A request counts toward its job's share if it was seated before
        the step or is seated after it (so work done by requests that
        retired mid-step, and by ones the step itself admitted, is still
        billed to their jobs). When no seated request maps to a job —
        e.g. a segment that only shuffled the admission queue — the delta
        is split evenly across the engine's jobs so counters never leak."""
        seated = seated0 | {id(r) for r in eng._slot_req if r is not None}
        counts: Dict[_WallJob, int] = {}
        for rid in seated:
            job = self._req_job.get(rid)
            if job is not None:
                counts[job] = counts.get(job, 0) + 1
        if not counts:
            counts = {j: 1 for j in self._active if j.eng is eng}
            if not counts:
                return
        total = sum(counts.values())
        delta = {k: eng.stats.get(k, 0) - occ0[k] for k in occ0}
        for job, n in counts.items():
            share = n / total
            for k, v in delta.items():
                if v:
                    job.occ[k] += v * share


class ServingRuntime:
    """Client surface of a wall-clock cluster (``make_cluster(...,
    clock="wall")``): thread-safe submission and drain-on-shutdown.

    ``submit(spec)`` may be called from any thread: the master's
    selection/dispatch is marshaled onto the ``RealClock`` scheduler
    thread (where every other control-plane callback runs) and the
    resulting ``QueryHandle`` is handed back. The handle then works as
    documented in ``core.api`` — ``result()`` blocks on its condition
    variable, ``on_tokens``/``iter_tokens`` stream live.
    """

    def __init__(self, cluster):
        if getattr(cluster.loop, "virtual", True):
            raise ValueError("ServingRuntime needs a wall-clock cluster "
                             "(make_cluster(..., clock='wall'))")
        self.cluster = cluster
        self.loop = cluster.loop
        self._inflight: List[Any] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def submit(self, spec, timeout: float = 30.0):
        """Submit from any thread; returns the ``QueryHandle``."""
        box: Dict[str, Any] = {}
        ev = threading.Event()

        def do():
            try:
                box["handle"] = self.cluster.api.submit(spec)
            except Exception as e:  # noqa: BLE001 - re-raised to caller
                box["error"] = e
            ev.set()

        self.loop.schedule(0.0, do)
        if not ev.wait(timeout):
            raise TimeoutError("control plane did not accept the query "
                               f"within {timeout}s")
        if "error" in box:
            raise box["error"]
        handle = box["handle"]
        with self._lock:
            self._inflight.append(handle)
        return handle

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every submitted query has completed; False if the
        deadline passed with work still in flight."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                self._inflight = [h for h in self._inflight if not h.done]
                n = len(self._inflight)
            if n == 0:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Stop serving: optionally drain in-flight queries, then stop
        stepper threads and the clock. Returns True on a clean drain."""
        ok = self.drain(timeout) if drain else True
        for ex in getattr(self.cluster, "executors", []):
            stop = getattr(ex, "shutdown", None)
            if stop is not None:
                stop()
        self.loop.shutdown()
        return ok
