"""Master: front-end, dispatcher & load balancer, hedged-request straggler
mitigation, and worker-lifecycle management (paper §4, Fig. 6).

The master is logically centralized; its durable state lives in the metadata
store (snapshot/restore covers master failure per paper §7). Decision latency
of every selection is recorded for the overhead analysis (paper §8.6).
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core import profiler as prof
from repro_torch.core.abstraction import ModelArchInfo, Variant
from repro_torch.core.api import (ArchTarget, QueryHandle, QuerySpec,
                            UseCaseTarget, VariantTarget, _spec_from_kwargs)
from repro_torch.core.autoscaler import (MasterAutoscaler, MasterScaleConfig,
                                   WorkerAutoscaler)
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.repository import ModelRepository
from repro_torch.core.selection import Selection, VariantSelector
from repro_torch.core.worker import OfflineJob, Query, Worker, WorkerConfig
from repro_torch.sim import hardware as HW
from repro_torch.sim.clock import Clock


@dataclasses.dataclass
class MasterConfig:
    worker: WorkerConfig = dataclasses.field(default_factory=WorkerConfig)
    scale: MasterScaleConfig = dataclasses.field(
        default_factory=MasterScaleConfig)
    hedge_enabled: bool = False
    hedge_factor: float = 3.0       # hedge when elapsed > factor * expected
    # bounded retry with exponential backoff + jitter: retry k (1-based)
    # waits min(retry_delay * retry_backoff**(k-1), retry_delay_cap),
    # scaled by a uniform +/- retry_jitter fraction (deterministic RNG) so
    # co-failing queries don't re-dispatch in lockstep
    retry_delay: float = 0.25
    retry_backoff: float = 2.0
    retry_delay_cap: float = 2.0
    retry_jitter: float = 0.1
    max_retries: int = 8
    heartbeat_timeout: float = 6.0
    # baseline-policy switches (paper §8.1): INDV = no variant upgrading;
    # STATIC = no worker autoscaling at all (preloaded fixed replicas)
    worker_autoscale: bool = True
    allow_upgrade: bool = True
    # health-aware routing: per-worker circuit breaker (closed -> open ->
    # half-open) fed by dispatch failures, engine pressure deltas from the
    # executor occupancy log, and heartbeat staleness. An open breaker
    # blacklists the worker so selection routes around it; after
    # ``breaker_cooldown`` it goes half-open (unblacklisted) and the next
    # query is the probe — success closes it, failure re-opens it.
    breaker_enabled: bool = False
    breaker_fail_threshold: int = 3     # consecutive failures to trip
    breaker_pressure_threshold: int = 8  # preempts+stalls per sweep window
    breaker_cooldown: float = 5.0       # open -> half-open delay


@dataclasses.dataclass
class _Breaker:
    """Per-worker circuit-breaker state (master-side health view)."""
    state: str = "closed"        # "closed" | "open" | "half-open"
    failures: int = 0            # consecutive failure signals while closed
    opened_at: float = 0.0
    trips: int = 0


class Master:
    def __init__(self, store: MetadataStore, repo: ModelRepository,
                 loop: Clock, cfg: MasterConfig = MasterConfig(),
                 autoscale: bool = True,
                 executor_factory: Optional[Callable[[], object]] = None):
        self.store = store
        self.repo = repo
        self.loop = loop
        self.cfg = cfg
        # data-plane seam: None -> profile-driven SimExecutor per worker;
        # a factory returning worker Executors -> real engines (backend
        # "real" in sim.cluster.make_cluster)
        self.executor_factory = executor_factory
        self.selector = VariantSelector(store)
        self.workers: Dict[str, Worker] = {}
        self.metrics: List[Query] = []
        self.offline_done: List[OfflineJob] = []
        self.decision_log: List[Tuple[str, bool, float]] = []
        self._qid = itertools.count()
        self._jid = itertools.count()
        self._worker_seq = itertools.count()
        self._retry_rng = random.Random(0)   # jitter: deterministic runs
        # health-aware routing state: per-worker breakers, the pressure
        # total already folded per worker (watermark against the
        # executor's monotone counter), and a transition log
        # (time, worker, new_state) for tests/benchmarks
        self._breakers: Dict[str, _Breaker] = {}
        self._occ_seen: Dict[str, float] = {}
        self.breaker_events: List[Tuple[float, str, str]] = []
        self.autoscaler = None
        if autoscale:
            self.autoscaler = MasterAutoscaler(
                store, loop, self._start_worker_async, self._stop_worker,
                cfg.scale)
        loop.every(cfg.worker.monitor_period, self._failure_sweep)

    # ------------------------------------------------------------------
    # cluster membership (elastic scaling)
    def add_worker(self, kind: str = "accel", name: Optional[str] = None,
                   slowdown: float = 1.0) -> Worker:
        hardware = ("cpu-host", "h100-1") if kind == "accel" \
            else ("cpu-host",)
        name = name or f"worker-{kind}-{next(self._worker_seq)}"
        executor = self.executor_factory() if self.executor_factory else None
        w = Worker(name, hardware, self.store, self.repo, self.loop,
                   self.cfg.worker, metrics=self.metrics, slowdown=slowdown,
                   executor=executor)
        if self.cfg.worker_autoscale:
            WorkerAutoscaler(w, self.store, self._request_worker_load,
                             allow_upgrade=self.cfg.allow_upgrade)
        self.workers[name] = w
        return w

    def _start_worker_async(self, kind: str, done: Callable) -> None:
        hw = HW.HARDWARE["h100-1" if kind == "accel" else "cpu-host"]

        def boot():
            self.add_worker(kind)
            done()
        self.loop.schedule(hw.startup_latency, boot)

    def _stop_worker(self, name: str) -> None:
        w = self.workers.pop(name, None)
        if w is not None:
            w.alive = False
            self.store.mark_dead(name)

    def fail_worker(self, name: str) -> None:
        """Failure injection entry point (tests/benchmarks)."""
        w = self.workers.get(name)
        if w is not None:
            w.fail()

    def _failure_sweep(self) -> None:
        """Detect dead workers via missed heartbeats; re-route their load.

        Routing goes through ``Worker.fail()`` — the same path explicit
        failure injection uses — so the timed-out worker's pending *and
        in-flight* queries fail through their ``done_cb`` and re-enter the
        master's retry machinery, instead of stranding forever on a
        machine that will never answer (a hung worker's scheduled
        completions never fire)."""
        now = self.loop.now()
        for name, st in list(self.store.workers.items()):
            if st.alive and now - st.heartbeat > self.cfg.heartbeat_timeout:
                self.store.mark_dead(name)
                w = self.workers.get(name)
                if w is not None:
                    w.fail()
        if self.cfg.breaker_enabled:
            self._breaker_sweep(now)

    # ------------------------------------------------------------------
    # health-aware routing: per-worker circuit breaker. Selection already
    # skips blacklisted workers everywhere (``running_instances_of``,
    # ``_worker_for_load``, the decision cache re-validation), so the
    # breaker routes by toggling ``WorkerState.blacklisted``.
    def _breaker_transition(self, name: str, br: _Breaker, state: str,
                            now: float) -> None:
        br.state = state
        st = self.store.workers.get(name)
        if st is not None:
            st.blacklisted = state == "open"
        self.breaker_events.append((now, name, state))

    def _breaker_failure(self, name: str) -> None:
        """One failure signal against a worker (failed dispatch, pressure
        burst, stale heartbeat). Closed: count toward the trip threshold.
        Half-open: the probe failed — straight back to open."""
        if not self.cfg.breaker_enabled or name not in self.workers:
            return
        now = self.loop.now()
        br = self._breakers.setdefault(name, _Breaker())
        if br.state == "open":
            return
        if br.state == "half-open" \
                or br.failures + 1 >= self.cfg.breaker_fail_threshold:
            br.failures = 0
            br.opened_at = now
            br.trips += 1
            self._breaker_transition(name, br, "open", now)
        else:
            br.failures += 1

    def _breaker_success(self, name: str) -> None:
        """A query completed cleanly on this worker: a half-open probe
        success closes the breaker; while closed, reset the consecutive-
        failure count."""
        if not self.cfg.breaker_enabled:
            return
        br = self._breakers.get(name)
        if br is None:
            return
        if br.state == "half-open":
            br.failures = 0
            self._breaker_transition(name, br, "closed", self.loop.now())
        elif br.state == "closed":
            br.failures = 0

    def _breaker_sweep(self, now: float) -> None:
        """Periodic health fold (rides the failure sweep): count engine
        pressure bursts and heartbeat staleness as failure signals, and
        move cooled-down open breakers to half-open (unblacklisted, so the
        next routed query probes the worker)."""
        for name, w in list(self.workers.items()):
            st = self.store.workers.get(name)
            if st is None or not st.alive:
                continue
            # engine pressure: preemption + pressure-stall deltas from the
            # data plane since the last sweep. Diff the executor's
            # monotone counter rather than the occupancy log: the log is
            # a bounded deque, so positional bookkeeping drifts once old
            # entries fall off the left.
            total = getattr(w.executor, "pressure_events_total", None)
            if total is not None:
                delta = total - self._occ_seen.get(name, 0.0)
                self._occ_seen[name] = total
                if delta >= self.cfg.breaker_pressure_threshold:
                    self._breaker_failure(name)
            # staleness short of the hard timeout: the worker is lagging
            # (hung or overloaded) but not yet declared dead
            if now - st.heartbeat > 0.5 * self.cfg.heartbeat_timeout:
                self._breaker_failure(name)
        for name, br in self._breakers.items():
            if br.state == "open" \
                    and now - br.opened_at >= self.cfg.breaker_cooldown:
                self._breaker_transition(name, br, "half-open", now)

    # ------------------------------------------------------------------
    # registration (paper §3.1)
    def register_model(self, cfg: ArchConfig, submitter: str = "public",
                       is_private: bool = False,
                       accuracy: Optional[float] = None) -> int:
        task, dataset, acc = prof.ARCH_META.get(
            cfg.name, ("text-generation", "openwebtext", 0.6))
        # "verify the accuracy of a public model" — the submitted accuracy
        # must match the profiler's validation run within tolerance.
        if accuracy is not None and abs(accuracy - acc) > 0.05:
            raise ValueError(
                f"accuracy verification failed for {cfg.name}: "
                f"submitted {accuracy}, validated {acc}")
        self.store.registry.add_arch(ModelArchInfo(
            name=cfg.name, task=task, dataset=dataset, accuracy=acc,
            submitter=submitter, is_private=is_private))
        n = 0
        for v in prof.generate_variants(cfg):
            self.store.registry.add_variant(v)
            self.repo.put_size(
                v.name, cfg.param_count() * prof.DTYPE_BYTES[
                    v.framework.split("-")[-1]])
            n += 1
        return n

    # ------------------------------------------------------------------
    # query path (paper §3.3 life cycle): one submit() for every
    # granularity and both modes; everything downstream replays the spec
    def submit(self, spec: QuerySpec) -> QueryHandle:
        if spec.mode == "offline":
            return self._submit_offline(spec)
        return self._submit_online(spec)

    def _select(self, spec: QuerySpec, batch: int,
                record: bool) -> Selection:
        """Run selection at the spec's granularity. ``record`` logs the
        decision latency (first dispatch only — redispatches and offline
        selections were never part of the §8.6 overhead account)."""
        t = spec.target
        t0 = time.perf_counter()
        if isinstance(t, VariantTarget):
            sel = self.selector.select_variant(t.name, batch)
            mode = "modvar"
        elif isinstance(t, ArchTarget):
            sel = self.selector.select_arch(t.name, batch, t.slo)
            mode = "modarch"
        else:
            sel = self.selector.select_usecase(
                t.task, t.dataset, t.min_accuracy, batch, t.slo, spec.user)
            mode = "usecase"
        if record:
            decision_us = (time.perf_counter() - t0) * 1e6
            self.decision_log.append((mode, sel.needs_load, decision_us))
        return sel

    def _query_from_spec(self, spec: QuerySpec, arrival: float,
                         hedge_of: Optional[int] = None) -> Query:
        """Materialize a Query from a spec; the flat target fields are
        copies for metrics attribution, the spec itself is authoritative."""
        t = spec.target
        return Query(
            qid=next(self._qid), kind="online", n_inputs=spec.n_inputs,
            slo=spec.slo, arrival=arrival,
            arch=t.name if isinstance(t, ArchTarget) else "",
            variant=t.name if isinstance(t, VariantTarget) else "",
            task=t.task if isinstance(t, UseCaseTarget) else "",
            dataset=t.dataset if isinstance(t, UseCaseTarget) else "",
            min_accuracy=t.min_accuracy
            if isinstance(t, UseCaseTarget) else 0.0,
            user=spec.user, spec=spec, payload=spec.payload,
            hedge_of=hedge_of)

    def _submit_online(self, spec: QuerySpec) -> QueryHandle:
        q = self._query_from_spec(spec, arrival=self.loop.now())
        handle = QueryHandle(spec, self.loop, query=q)
        q.done_cb = handle._complete
        # streaming executors forward per-segment tokens through the query
        # straight into the handle (hedged duplicates are created without
        # a sink, so only the primary copy ever streams)
        q.on_tokens = handle._push_tokens
        sel = self._select(spec, batch=spec.n_inputs, record=True)
        self._dispatch(q, sel, retries=0)
        return handle

    def _retry_delay_for(self, retries: int) -> float:
        """Backoff before retry number ``retries + 1``: exponential in the
        retries already burned, capped, with deterministic +/- jitter."""
        base = min(self.cfg.retry_delay * self.cfg.retry_backoff ** retries,
                   self.cfg.retry_delay_cap)
        jit = self.cfg.retry_jitter * (2.0 * self._retry_rng.random() - 1.0)
        return max(base * (1.0 + jit), 0.0)

    def _schedule_retry(self, q: Query, retries: int) -> None:
        self.loop.schedule(self._retry_delay_for(retries),
                           lambda: self._redispatch(q, retries + 1))

    def _dispatch(self, q: Query, sel: Selection, retries: int) -> None:
        q.attempts = retries + 1
        if sel.variant is None or sel.worker is None:
            if retries < self.cfg.max_retries:
                self._schedule_retry(q, retries)
            else:
                q.failed = True
                q.finish = self.loop.now()
                self.metrics.append(q)
                if q.done_cb:
                    q.done_cb(q)
            return
        q.variant = sel.variant.name
        worker = self.workers.get(sel.worker)
        if worker is None or not worker.alive:
            self._schedule_retry(q, retries)
            return
        if sel.needs_load and self.store.instance(
                sel.variant.name, sel.worker) is None:
            worker.load_variant(sel.variant)
            q.load_wait = sel.variant.profile.load_latency * worker.slowdown
        orig_cb = q.done_cb

        def on_done(qq: Query) -> None:
            if qq.failed:
                self._breaker_failure(sel.worker)
                if retries < self.cfg.max_retries:
                    # worker died under the query (or rejected it): back
                    # off, then replay the immutable spec through
                    # selection again
                    qq.failed = False
                    qq.done_cb = orig_cb
                    self._schedule_retry(qq, retries)
                    return
            else:
                self._breaker_success(qq.worker or sel.worker)
            if orig_cb:
                orig_cb(qq)
        q.done_cb = on_done
        worker.enqueue(q, sel.variant.name)
        if self.cfg.hedge_enabled and q.slo is not None:
            self._arm_hedge(q, sel)

    def _redispatch(self, q: Query, retries: int) -> None:
        # replay the immutable spec at its original granularity — no
        # re-derivation from sentinel fields (q.variant is overwritten as
        # a side effect of every dispatch and cannot be trusted here)
        self._dispatch(q, self._select(q.spec, batch=q.n_inputs,
                                       record=False), retries)

    # -- hedged requests (straggler mitigation, DESIGN.md §6) -------------
    def _arm_hedge(self, q: Query, sel: Selection) -> None:
        v = sel.variant
        expected = v.profile.latency(q.n_inputs) + (
            v.profile.load_latency if sel.needs_load else 0.0)
        trigger = self.cfg.hedge_factor * max(expected, 1e-3)

        def check():
            if q.finish >= 0 or q.failed or q.cancelled:
                return
            insts = [i for i in self.store.running_instances_of(v.name)
                     if i.worker != sel.worker]
            if not insts:
                return
            backup = min(insts, key=lambda i: i.qps)
            # the duplicate is derived from the original spec, so hedges
            # of use-case and variant-named queries keep task / dataset /
            # min_accuracy / user / payload, and metrics attribute them
            # to the right tenant and use case
            dup = self._query_from_spec(q.spec, arrival=q.arrival,
                                        hedge_of=q.qid)

            def first_wins(winner: Query) -> None:
                if winner.failed or winner.finish < 0:
                    return            # dead duplicate must not complete
                #                       the original with bogus state
                if q.finish >= 0:
                    return            # original already answered
                q.finish = winner.finish
                q.start = winner.start
                q.variant = winner.variant
                q.worker = winner.worker
                q.violated = winner.violated
                q.outputs = winner.outputs
                q.load_wait = winner.load_wait
                q.degraded = winner.degraded
                q.preemptions = winner.preemptions
                q.cancelled = False
                if q.done_cb:
                    q.done_cb(q)
            dup.done_cb = first_wins
            w = self.workers.get(backup.worker)
            if w is not None:
                w.enqueue(dup, v.name)
        self.loop.schedule(trigger, check)

    # ------------------------------------------------------------------
    # offline queries (paper §3.2: best-effort, no latency option) — same
    # spec/handle machinery as online, including the scheduled-retry path
    # when selection cannot place the job yet
    def _submit_offline(self, spec: QuerySpec) -> QueryHandle:
        job = OfflineJob(jid=next(self._jid), variant="",
                         total_inputs=spec.n_inputs, spec=spec,
                         payload=spec.payload, arrival=self.loop.now())
        handle = QueryHandle(spec, self.loop, job=job)

        def record(j: OfflineJob) -> None:
            j.finish = self.loop.now()
            if not j.failed:
                self.offline_done.append(j)
            handle._complete()
        job.done_cb = record
        self._dispatch_offline(job, retries=0)
        return handle

    def _dispatch_offline(self, job: OfflineJob, retries: int) -> None:
        job.attempts = retries + 1
        sel = self._select(job.spec, batch=1, record=False)
        worker = None
        if sel.variant is not None and sel.worker is not None:
            worker = self.workers.get(sel.worker)
            if worker is not None and not worker.alive:
                worker = None
        if worker is not None and sel.needs_load and self.store.instance(
                sel.variant.name, sel.worker) is None:
            if not worker.load_variant(sel.variant):
                # selection used heartbeat-stale memory accounting and the
                # device filled meanwhile: re-enter the retry loop rather
                # than parking the job on a worker that will never host
                # the variant
                worker = None
        if worker is None:
            # nothing can serve it yet: backed-off scheduled retry, like
            # online
            if retries < self.cfg.max_retries:
                self.loop.schedule(
                    self._retry_delay_for(retries),
                    lambda: self._dispatch_offline(job, retries + 1))
            else:
                job.failed = True
                if job.done_cb:
                    job.done_cb(job)
            return
        job.variant = sel.variant.name
        worker.submit_offline(job)

    # ------------------------------------------------------------------
    # deprecated kwargs forms (thin shims over QuerySpec)
    def online_query(self, *, n_inputs: int = 1, slo: Optional[float] = None,
                     arch: Optional[str] = None,
                     variant: Optional[str] = None,
                     task: Optional[str] = None, dataset: Optional[str] = None,
                     accuracy: float = 0.0, user: str = "public",
                     done_cb: Optional[Callable] = None) -> Query:
        warnings.warn("Master.online_query(**kwargs) is deprecated; use "
                      "submit(QuerySpec...)", DeprecationWarning,
                      stacklevel=2)
        spec = _spec_from_kwargs(mode="online", variant=variant, arch=arch,
                                 task=task, dataset=dataset,
                                 accuracy=accuracy, slo=slo, user=user,
                                 n_inputs=n_inputs)
        h = self.submit(spec)
        if done_cb is not None:
            h.add_done_callback(lambda hh: done_cb(hh.query))
        return h.query

    def offline_query(self, *, n_inputs: int, arch: Optional[str] = None,
                      variant: Optional[str] = None,
                      task: Optional[str] = None,
                      dataset: Optional[str] = None, accuracy: float = 0.0,
                      done_cb: Optional[Callable] = None) -> OfflineJob:
        warnings.warn("Master.offline_query(**kwargs) is deprecated; use "
                      "submit(QuerySpec(..., mode='offline'))",
                      DeprecationWarning, stacklevel=2)
        spec = _spec_from_kwargs(mode="offline", variant=variant, arch=arch,
                                 task=task, dataset=dataset,
                                 accuracy=accuracy, slo=None, user="public",
                                 n_inputs=n_inputs)
        h = self.submit(spec)
        if done_cb is not None:
            h.add_done_callback(lambda hh: done_cb(hh.job))
        return h.job

    # ------------------------------------------------------------------
    # worker-initiated placements (upgrade to hardware the worker lacks)
    def _request_worker_load(self, variant: Variant, origin: str) -> None:
        sel_worker = self.selector._worker_for_load(variant)
        if sel_worker is None:
            return
        w = self.workers.get(sel_worker)
        if w is not None and self.store.instance(
                variant.name, sel_worker) is None:
            w.load_variant(variant)
