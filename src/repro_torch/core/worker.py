"""Worker: executors, per-variant queues with adaptive batching, monitoring
daemon, and offline best-effort execution (paper §4, §6.2, §8.3).

Execution model (DESIGN.md §2): an accelerator device is a single temporal-
sharing resource (one job in service, FIFO across co-resident variants; no
replication on-accelerator, per paper §6.2); the host CPU offers
``cores // cores_per_replica`` concurrent slots and variants scale on it by
replication.

The data plane behind a device is pluggable through the ``Executor``
protocol: ``run(variant, batch, requests)`` returns the service time of
one batch; ``requests`` carries each co-batched query's ``ExecRequest``
(real payload prompts in, generated token ids out via ``on_outputs``).
``SimExecutor`` (default) answers from the variant's profiled
t(b) = m*b + c; ``repro_torch.serving.executor.EngineExecutor`` actually
runs the batch through a real continuous-batching ``ServingEngine`` and
returns the measured wall time. Everything downstream — ``_submit``/``_complete``, the
monitoring daemon, and model-level autoscaling — operates identically over
both, so the INFaaS control plane drives simulated and real execution
through the same seam. (``EngineExecutor`` lives in ``repro_torch.serving``
so the control plane stays importable without torch.)
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Protocol,
                    Tuple, runtime_checkable)

from repro_torch.core.metadata import InstanceState, MetadataStore
from repro_torch.core.repository import ModelRepository
from repro_torch.sim import hardware as HW
from repro_torch.sim.clock import Clock


def _locked(fn):
    """Serialize a Worker method under the instance lock. Under the
    EventLoop every entry point already runs on the single pumping thread;
    under the wall-clock runtime, clock callbacks (scheduler thread) and
    executor completions (stepper threads) interleave, so every method that
    mutates pending/in-flight maps takes the reentrant lock."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


@dataclasses.dataclass
class Query:
    qid: int
    kind: str                       # "online" | "offline"
    n_inputs: int
    slo: Optional[float]
    arrival: float
    arch: str = ""
    variant: str = ""
    # use-case granularity (paper §3.2): kept as flat fields for metrics
    # attribution; the authoritative description is ``spec``
    task: str = ""
    dataset: str = ""
    min_accuracy: float = 0.0
    user: str = "public"
    # the immutable api.QuerySpec this query was built from; redispatch
    # and hedging replay it instead of re-deriving granularity from the
    # sentinel fields above (typed Any: the control plane stays free of an
    # api-module import cycle)
    spec: Any = None
    # api.QueryPayload: real token-id prompts threaded down to the
    # executor; ``outputs`` comes back from a real engine (one token-id
    # array per prompt, submission order)
    payload: Any = None
    outputs: Optional[List[Any]] = None
    load_wait: float = 0.0          # load latency this query paid
    worker: str = ""
    start: float = -1.0
    finish: float = -1.0
    violated: bool = False
    failed: bool = False
    cancelled: bool = False         # hedging: the losing copy is cancelled
    hedge_of: Optional[int] = None
    # dispatch attempts so far (1 = first try); the master stamps this on
    # every (re)dispatch so results can surface how hard placement was
    attempts: int = 0
    # served correctly but on borrowed time: some of this query's work was
    # preempted under memory pressure and recovered (bit-identical replay)
    degraded: bool = False
    preemptions: int = 0            # engine preempt count behind `degraded`
    # deadline enforcement: the engine cancelled this query's generation
    # past its SLO deadline (partial tokens may still be delivered)
    timed_out: bool = False
    done_cb: Optional[Callable[["Query"], None]] = None
    # streaming sink: called (input_idx, new_tokens, t_wall, start) as
    # decode segments retire on a streaming executor; None = no
    # streaming. ``start`` is the chunk's absolute token offset within
    # that input's output — a re-dispatched query regenerates from
    # position 0, and the handle uses the offset to suppress tokens it
    # already delivered before the first attempt failed
    on_tokens: Optional[Callable[[int, List[int], float, int], None]] = None
    # wall time of the query's first streamed tokens (-1 until then);
    # first_token - arrival is the query's TTFT
    first_token: float = -1.0

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


@dataclasses.dataclass
class OfflineJob:
    jid: int
    variant: str
    total_inputs: int
    processed: int = 0
    spec: Any = None                # api.QuerySpec (mode="offline")
    payload: Any = None             # api.QueryPayload; chunks are sliced
    #                                 from it as the job advances
    outputs: List[Any] = dataclasses.field(default_factory=list)
    arrival: float = 0.0
    finish: float = -1.0
    failed: bool = False            # no capacity after max_retries
    attempts: int = 0               # placement attempts (backoff between)
    degraded: bool = False          # any chunk recovered from a preempt
    done_cb: Optional[Callable[["OfflineJob"], None]] = None

    @property
    def done(self) -> bool:
        return self.processed >= self.total_inputs


@dataclasses.dataclass
class ExecRequest:
    """One logical query's slice of a device batch, handed to the Executor.

    ``prompts`` carries the query's real token-id prompts (empty tuple ->
    the executor substitutes synthetic inputs, ``n_inputs`` of them).
    ``on_outputs`` is called with the per-input generated token-id arrays
    when a real executor finishes the batch; sim executors ignore it.
    ``slo`` threads the query's latency objective down to the engine's
    SLO-aware preemption; ``on_report`` carries the degradation verdict
    (preemption counts) back when a real executor finishes.
    """
    n_inputs: int
    prompts: Tuple = ()
    max_new_tokens: int = 0         # 0 -> executor default
    on_outputs: Optional[Callable[[List[Any]], None]] = None
    slo: Optional[float] = None
    on_report: Optional[Callable[[Dict[str, Any]], None]] = None
    # streaming sink: (input_idx, new_tokens, t_wall) per harvested
    # segment, in emission order; only streaming executors call it
    on_tokens: Optional[Callable[[int, List[int], float], None]] = None


@runtime_checkable
class Executor(Protocol):
    """Data plane behind a worker device.

    ``run(variant, batch, requests)`` performs (or models) the service of
    one batch on the variant and returns its service time in seconds.
    ``requests`` (optional) carries one ``ExecRequest`` per co-batched
    query — real payload prompts in, generated tokens out via each
    request's ``on_outputs`` sink. Called when a job actually starts on a
    device slot; the worker schedules the job's completion that far into
    the future, so simulated and real execution share the whole
    dispatch/monitor/autoscale machinery.
    """

    def run(self, variant, batch: int,
            requests: Optional[List[ExecRequest]] = None) -> float:
        ...

    # Executors may additionally expose
    #   run_async(variant, batch, requests, on_done)
    # returning immediately; ``on_done(duration, error)`` fires later from
    # the executor's own thread. When present, the worker routes jobs
    # through it instead of blocking the clock thread in ``run``. No
    # executor of this package implements it yet (the wall-clock runtime
    # is not ported).


class SimExecutor:
    """Profile-driven executor: service time from the variant's t(b) fit
    (optionally overridden by a ``service_time_fn(variant, batch)``).
    Payloads are accounted but not executed — no outputs are produced."""

    def __init__(self, service_time_fn: Optional[Callable] = None):
        self.service_time_fn = service_time_fn

    def run(self, variant, batch: int,
            requests: Optional[List[ExecRequest]] = None) -> float:
        if self.service_time_fn is not None:
            return self.service_time_fn(variant, batch)
        return variant.profile.latency(batch)


@dataclasses.dataclass
class WorkerConfig:
    monitor_period: float = 2.0
    autoscale_period: float = 1.0
    headroom: float = 0.05          # absorb 5% spikes (paper §6.2)
    t_down_cpu: int = 10            # scale-down hysteresis (paper §6.2)
    t_down_accel: int = 20
    cpu_cores: int = 8
    cores_per_replica: int = 2
    qps_window: float = 4.0         # EWMA window for rate estimates
    offline_util_cap: float = 0.9   # pause offline above this CPU util
    # chaos testing: a serving.faults.FaultInjector consulted by the
    # monitor daemon ("worker_hang" / "worker_crash" sites); None = off
    faults: Optional[Any] = None


class _Device:
    def __init__(self, hw: HW.HardwareSpec, slots: int):
        self.hw = hw
        self.slots = slots
        self.active = 0
        self.mem_used = 0.0
        self.busy_accum = 0.0       # busy seconds since last monitor tick
        self.window_start = 0.0     # time of the last monitor tick
        self.running: set = set()   # in-flight _Jobs (for live busy credit)
        self.waiting: Deque = deque()

    @property
    def idle(self) -> bool:
        return self.active == 0 and not self.waiting


class _Job:
    __slots__ = ("instance", "queries", "batch", "offline_job", "duration",
                 "start_time", "requests", "abandoned")

    def __init__(self, instance, queries, batch, offline_job=None,
                 requests=None):
        self.instance = instance
        self.queries = queries
        self.batch = batch
        self.offline_job = offline_job
        self.duration = 0.0
        self.start_time = 0.0
        # per-query ExecRequests: real payload prompts down, outputs back
        self.requests: List[ExecRequest] = requests or []
        # worker failed over while this job was queued/in flight: its
        # queries were already failed through the retry path, so the
        # stale scheduled completion must become a no-op
        self.abandoned = False


class _LocalInstance:
    """Worker-local execution state of one variant instance."""

    def __init__(self, variant, replicas: int = 1):
        self.variant = variant      # abstraction.Variant
        self.replicas = replicas
        self.outstanding = 0
        self.pending: Deque[Query] = deque()
        # stats since last monitor tick
        self.completed_inputs = 0.0
        self.lat_sum = 0.0
        self.lat_n = 0
        self.running = False


class Worker:
    def __init__(self, name: str, hardware, store: MetadataStore,
                 repo: ModelRepository, loop: Clock,
                 cfg: WorkerConfig = WorkerConfig(),
                 metrics: Optional[List[Query]] = None,
                 service_time_fn: Optional[Callable] = None,
                 slowdown: float = 1.0,
                 executor: Optional[Executor] = None):
        self.name = name
        self.hardware = tuple(hardware)
        self.store = store
        self.repo = repo
        self.loop = loop
        self.cfg = cfg
        # guards pending/in-flight maps against stepper-thread completions
        # under the wall-clock runtime (reentrant: _complete -> dispatch)
        self._lock = threading.RLock()
        self.metrics = metrics if metrics is not None else []
        self.alive = True
        # fault injection: a hung worker is alive but frozen — heartbeats
        # stop, in-flight jobs never complete, nothing new dispatches.
        # Only the master's heartbeat sweep can detect and fail it.
        self._hung = False
        self.slowdown = slowdown    # straggler injection (>1 = slow worker)
        self.instances: Dict[str, _LocalInstance] = {}
        self.offline_jobs: List[OfflineJob] = []
        self.recent_violations = 0
        self.executor: Executor = executor if executor is not None \
            else SimExecutor(service_time_fn)
        self.devices: Dict[str, _Device] = {}
        for hname in self.hardware:
            hw = HW.HARDWARE[hname]
            slots = 1 if hw.kind == "accel" else max(
                1, cfg.cpu_cores // cfg.cores_per_replica)
            self.devices[hname] = _Device(hw, slots)
        store.upsert_worker(name, self.hardware, loop.now())
        store.heartbeat(name, {h: 0.0 for h in self.hardware},
                        {h: 0.0 for h in self.hardware}, loop.now())
        loop.every(cfg.monitor_period, self.monitor_tick,
                   stop=lambda: not self.alive)

    # ------------------------------------------------------------------
    # variant lifecycle
    @_locked
    def load_variant(self, variant, on_ready: Optional[Callable] = None,
                     replicas: int = 1) -> bool:
        """Start loading a variant; becomes running after its load latency."""
        dev = self.devices.get(variant.hardware)
        if dev is None:
            return False   # this worker lacks the target hardware
        mem = variant.profile.peak_memory
        if dev.mem_used + mem > dev.hw.mem_capacity:
            return False
        if variant.name in self.instances:
            return True
        dev.mem_used += mem
        li = _LocalInstance(variant, replicas)
        self.instances[variant.name] = li
        inst = InstanceState(variant=variant.name, worker=self.name,
                            replicas=replicas, running=False, loading=True)
        self.store.set_instance(inst)

        def ready():
            with self._lock:
                if not self.alive or variant.name not in self.instances:
                    return
                li.running = True
                st = self.store.instance(variant.name, self.name)
                if st is not None:
                    st.loading = False
                    st.running = True
                self._try_dispatch(variant.name)
                self._pump_offline()
            if on_ready:
                on_ready()

        self.loop.schedule(variant.profile.load_latency * self.slowdown,
                           ready)
        return True

    @_locked
    def unload_variant(self, vname: str) -> None:
        li = self.instances.pop(vname, None)
        if li is None:
            return
        dev = self.devices[li.variant.hardware]
        dev.mem_used -= li.variant.profile.peak_memory
        self.store.drop_instance(vname, self.name)
        for q in li.pending:   # re-dispatch responsibility is the master's
            q.failed = True
            if q.done_cb:
                q.done_cb(q)

    @_locked
    def set_replicas(self, vname: str, replicas: int) -> None:
        li = self.instances.get(vname)
        if li is None:
            return
        li.replicas = max(1, replicas)
        st = self.store.instance(vname, self.name)
        if st is not None:
            st.replicas = li.replicas
        self._try_dispatch(vname)

    # ------------------------------------------------------------------
    # query path
    @_locked
    def enqueue(self, q: Query, vname: str) -> None:
        if not self.alive:
            q.failed = True
            if q.done_cb:
                q.done_cb(q)
            return
        li = self.instances.get(vname)
        if li is None:
            q.failed = True
            if q.done_cb:
                q.done_cb(q)
            return
        q.worker = self.name
        li.pending.append(q)
        if li.running:
            self._try_dispatch(vname)

    def _concurrency(self, li: _LocalInstance) -> int:
        hw = HW.HARDWARE[li.variant.hardware]
        return 1 if hw.kind == "accel" else li.replicas

    def _service_time(self, job: _Job) -> float:
        return self.executor.run(job.instance.variant, job.batch,
                                 job.requests or None) * self.slowdown

    def _exec_request(self, q: Query) -> ExecRequest:
        """The executor-facing slice of one query: real prompts when the
        query carries a payload (outputs land back on ``q.outputs``),
        synthetic accounting otherwise — tokens decoded from synthetic
        stand-ins are not answers, so no sink is attached. Either way the
        query's SLO rides along (the engine's preemption policy is
        slack-based) and any degradation report lands back on the query."""

        def report(rep, qq=q):
            qq.preemptions += int(rep.get("preemptions", 0))
            qq.degraded = qq.degraded or bool(rep.get("degraded"))
            qq.timed_out = qq.timed_out or bool(rep.get("timed_out"))

        # per-attempt emission cursor: each dispatch regenerates every
        # input from token 0 (decode is deterministic), so this attempt's
        # running count per input is the chunk's absolute offset. The
        # handle diffs it against what it already delivered — a retry on
        # a different worker after a partial stream re-sends the prefix,
        # and the handle drops the overlap instead of duplicating tokens.
        sent: Dict[int, int] = {}

        def tokens(idx, toks, _t, qq=q, sent=sent):
            # re-stamp on the control plane's clock (the engine timestamps
            # on its own perf_counter base): first_token - arrival is then
            # the query's TTFT on the same timebase as every other metric.
            # A hedged/cancelled copy stops forwarding, but the TTFT
            # measurement stands.
            t = self.loop.now()
            if qq.first_token < 0.0:
                qq.first_token = t
            start = sent.get(idx, 0)
            sent[idx] = start + len(toks)
            if qq.on_tokens is not None and not qq.cancelled:
                qq.on_tokens(idx, toks, t, start)

        if q.payload is not None:
            return ExecRequest(
                n_inputs=q.n_inputs, prompts=q.payload.prompts,
                max_new_tokens=q.payload.max_new_tokens,
                on_outputs=lambda outs, qq=q: setattr(qq, "outputs", outs),
                slo=q.slo, on_report=report,
                on_tokens=tokens if q.on_tokens is not None else None)
        return ExecRequest(n_inputs=q.n_inputs, slo=q.slo,
                           on_report=report)

    @_locked
    def _try_dispatch(self, vname: str) -> None:
        li = self.instances.get(vname)
        if li is None or not li.running or self._hung:
            return
        dev = self.devices[li.variant.hardware]
        while li.pending and li.outstanding < self._concurrency(li):
            # adaptive batching: drain up to the variant's max batch
            queries: List[Query] = []
            batch = 0
            while li.pending and batch < li.variant.profile.max_batch:
                nxt = li.pending[0]
                if nxt.cancelled:
                    li.pending.popleft()
                    continue
                if batch + nxt.n_inputs > li.variant.profile.max_batch \
                        and queries:
                    break
                q = li.pending.popleft()
                queries.append(q)
                batch += q.n_inputs
            if not queries:
                return
            job = _Job(li, queries, batch,
                       requests=[self._exec_request(q) for q in queries])
            li.outstanding += 1
            self._submit(dev, job)

    def _submit(self, dev: _Device, job: _Job) -> None:
        if dev.active < dev.slots:
            self._start(dev, job)
        else:
            dev.waiting.append(job)

    def _start(self, dev: _Device, job: _Job) -> None:
        run_async = getattr(self.executor, "run_async", None)
        if run_async is not None:
            self._start_async(dev, job, run_async)
            return
        # service time is resolved when the job actually starts on a slot:
        # a real executor runs the batch here (and measures it), a sim
        # executor just evaluates the profile — either way the completion
        # is scheduled that far into the future
        try:
            job.duration = self._service_time(job)
        except Exception:
            # a bad batch (e.g. a payload exceeding the real engine's
            # max_len) must not escape into the event loop and wedge the
            # device slot: fail the work, keep the slot usable
            self._fail_job(dev, job)
            return
        dev.active += 1
        now = self.loop.now()
        job.start_time = now
        dev.running.add(job)
        for q in job.queries:
            if q.start < 0:
                q.start = now
        self.loop.schedule(job.duration, lambda: self._complete(dev, job))

    def _start_async(self, dev: _Device, job: _Job,
                     run_async: Callable) -> None:
        """Wall-clock path: hand the job to a threaded executor and return
        immediately — the clock thread never blocks on real decode. The
        executor's stepper thread calls ``on_done`` when the batch retires;
        completion is marshaled back through ``loop.schedule(0, ...)`` so
        ``_complete`` runs on the scheduler thread like every other
        control-plane callback (the worker lock covers the overlap)."""
        dev.active += 1
        now = self.loop.now()
        job.start_time = now
        dev.running.add(job)
        for q in job.queries:
            if q.start < 0:
                q.start = now

        def on_done(duration: float, error=None):
            def finish():
                if error is not None:
                    with self._lock:
                        dev.active -= 1
                        dev.running.discard(job)
                        self._fail_job(dev, job)
                    return
                job.duration = duration
                self._complete(dev, job)
            self.loop.schedule(0.0, finish)

        try:
            run_async(job.instance.variant, job.batch,
                      job.requests or None, on_done)
        except Exception:
            dev.active -= 1
            dev.running.discard(job)
            self._fail_job(dev, job)

    @_locked
    def _fail_job(self, dev: _Device, job: _Job) -> None:
        """Executor rejected the batch before it started: surface failure
        (the master's retry path owns what happens next) and keep the
        device draining."""
        li = job.instance
        if job.offline_job is None:
            li.outstanding -= 1
            for q in job.queries:
                q.failed = True
                if q.done_cb:
                    q.done_cb(q)
        else:
            job.offline_job.failed = True
            if job.offline_job in self.offline_jobs:
                # drop it, or _pump_offline would retry the poisoned
                # chunk on every monitor tick forever
                self.offline_jobs.remove(job.offline_job)
            if job.offline_job.done_cb:
                job.offline_job.done_cb(job.offline_job)
        if dev.waiting and dev.active < dev.slots:
            self._start(dev, dev.waiting.popleft())

    @_locked
    def _complete(self, dev: _Device, job: _Job) -> None:
        if job.abandoned or self._hung:
            # abandoned: fail() already failed this job's queries through
            # the retry path — completing it too would double-fire their
            # callbacks onto the retried copies. Hung: a frozen worker
            # finishes nothing; the job stays wedged until the master's
            # heartbeat sweep fails this worker.
            return
        if not self.alive:
            # worker died mid-flight: surface the failure to the master
            for q in job.queries:
                q.failed = True
                if q.done_cb:
                    q.done_cb(q)
            return
        dev.active -= 1
        dev.running.discard(job)
        now = self.loop.now()
        # credit only the part of the job inside the current monitor window;
        # the earlier part was credited live by monitor_tick
        dev.busy_accum += now - max(job.start_time, dev.window_start)
        li = job.instance
        if job.offline_job is None:
            li.outstanding -= 1
            for q in job.queries:
                if q.finish >= 0:
                    # a hedged duplicate already answered this query
                    # (``Master._arm_hedge``): the losing copy's completion
                    # must not re-stamp the winner's finish or fire its
                    # callback twice
                    continue
                q.finish = now
                q.variant = li.variant.name
                if q.slo is not None and q.latency > q.slo:
                    q.violated = True
                    self.recent_violations += 1
                li.completed_inputs += q.n_inputs
                li.lat_sum += q.latency
                li.lat_n += 1
                self.metrics.append(q)
                if q.done_cb:
                    q.done_cb(q)
        else:
            job.offline_job.processed += job.batch
            li.completed_inputs += job.batch
            if job.offline_job.done and job.offline_job.done_cb:
                job.offline_job.done_cb(job.offline_job)
        # drain device queue, then instance queues, then offline slack
        if dev.waiting and dev.active < dev.slots:
            self._start(dev, dev.waiting.popleft())
        if self.alive:
            if job.offline_job is None:
                self._try_dispatch(li.variant.name)
            self._pump_offline()

    # ------------------------------------------------------------------
    # offline best-effort (paper §8.3, Fig. 10)
    @_locked
    def submit_offline(self, job: OfflineJob) -> None:
        self.offline_jobs.append(job)
        self._pump_offline()

    def _offline_throttled(self) -> bool:
        if self.recent_violations > 0:
            return True
        cpu = self.devices.get("cpu-host")
        if cpu is not None:
            # crude live-util probe: all slots busy -> back off
            if cpu.active >= cpu.slots:
                return True
        return False

    @_locked
    def _pump_offline(self) -> None:
        if not self.alive or self._hung or self._offline_throttled():
            return
        for job in list(self.offline_jobs):
            if job.done or job.failed:
                self.offline_jobs.remove(job)
                continue
            li = self.instances.get(job.variant)
            if li is None or not li.running:
                continue
            dev = self.devices[li.variant.hardware]
            # only absorb slack: device must be idle and no online backlog
            if not dev.idle or li.pending:
                continue
            chunk = min(job.total_inputs - job.processed,
                        li.variant.profile.max_batch)
            reqs = []
            if job.payload is not None:
                # slice this chunk's real prompts from the staged payload
                # (one chunk in flight per device: dev.idle gate above)
                sl = job.payload.prompts[job.processed:job.processed + chunk]
                reqs = [ExecRequest(
                    n_inputs=chunk, prompts=sl,
                    max_new_tokens=job.payload.max_new_tokens,
                    on_outputs=lambda outs, jj=job: jj.outputs.extend(outs),
                    on_report=lambda rep, jj=job: setattr(
                        jj, "degraded",
                        jj.degraded or bool(rep.get("degraded"))))]
            j = _Job(li, [], chunk, offline_job=job, requests=reqs)
            self._submit(dev, j)

    # ------------------------------------------------------------------
    # monitoring daemon (2 s updates, paper §4/§7)
    @_locked
    def monitor_tick(self) -> None:
        if not self.alive or self._hung:
            return
        f = self.cfg.faults
        if f is not None:
            # injected machine-level failures ride the monitor daemon: a
            # crash fails everything immediately (retry path); a hang
            # freezes the worker until the master's heartbeat sweep
            if f.fire("worker_crash"):
                self.fail()
                return
            if f.fire("worker_hang"):
                self.hang()
                return
        now = self.loop.now()
        window = self.cfg.monitor_period
        util, mem = {}, {}
        for hname, dev in self.devices.items():
            # completed-in-window time plus the elapsed share of in-flight
            # jobs — otherwise long-running jobs report an idle device for
            # their whole service time and mislead the autoscaler
            busy = dev.busy_accum + sum(
                now - max(j.start_time, dev.window_start)
                for j in dev.running)
            util[hname] = min(1.0, busy / (window * dev.slots))
            mem[hname] = dev.mem_used
            dev.busy_accum = 0.0
            dev.window_start = now
        self.store.heartbeat(self.name, util, mem, now)
        for vname, li in self.instances.items():
            st = self.store.instance(vname, self.name)
            if st is None:
                continue
            qps = li.completed_inputs / window
            st.qps = 0.5 * st.qps + 0.5 * qps
            if li.lat_n:
                st.avg_latency = li.lat_sum / li.lat_n
            st.replicas = li.replicas
            st.running = li.running
            li.completed_inputs = 0.0
            li.lat_sum, li.lat_n = 0.0, 0
        self.recent_violations = 0
        self._pump_offline()   # periodic re-probe for slack

    # ------------------------------------------------------------------
    # failure injection (fault-tolerance tests)
    def hang(self) -> None:
        """Freeze the worker without marking it dead: heartbeats stop,
        in-flight jobs never complete, new work queues but never runs.
        Models a wedged machine — only the master's heartbeat sweep can
        detect it (``Master._failure_sweep`` then calls ``fail()``, which
        routes every stranded query into the retry path)."""
        self._hung = True

    @_locked
    def fail(self) -> None:
        """Kill the worker: everything it holds — pending queries, jobs
        waiting on a device, and jobs in flight — fails through ``done_cb``
        so the master's retry machinery re-dispatches it elsewhere. The
        jobs' already-scheduled completions are marked abandoned and
        become no-ops."""
        self.alive = False
        self.store.mark_dead(self.name)
        for dev in self.devices.values():
            for job in list(dev.running) + list(dev.waiting):
                self._abandon_job(job)
            dev.running.clear()
            dev.waiting.clear()
            dev.active = 0
        for li in self.instances.values():
            li.outstanding = 0
            for q in li.pending:
                q.failed = True
                if q.done_cb:
                    q.done_cb(q)
            li.pending.clear()

    def _abandon_job(self, job: _Job) -> None:
        """Fail a queued/in-flight job of a dead worker: queries go back
        to the master's retry path, offline jobs surface failure."""
        job.abandoned = True
        if job.offline_job is None:
            for q in job.queries:
                q.failed = True
                if q.done_cb:
                    q.done_cb(q)
        else:
            job.offline_job.failed = True
            if job.offline_job in self.offline_jobs:
                self.offline_jobs.remove(job.offline_job)
            if job.offline_job.done_cb:
                job.offline_job.done_cb(job.offline_job)
