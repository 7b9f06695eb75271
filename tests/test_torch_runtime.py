"""The port's wall-clock serving runtime (``repro_torch.serving.runtime``)
and fault injection on the CPU, reduced size.

* Mirrors of the reference's ``test_runtime_wall.py`` and
  ``test_faults.py``: ``make_cluster(backend="real", clock="wall",
  device="cpu", reduced=True)`` under ``ServingRuntime`` streams payload
  queries, retries through a worker hang, a stepper death and a dispatch
  fault, and turns a 1 ms SLO into a ``timed_out`` verdict; the threaded
  executor survives two submitting threads and splits co-batched
  occupancy; the injector replays, and the breaker and worker faults run
  through the sim cluster.
* Parity: a wall-clock serve of both llama variants, the port's executor
  holding the JAX package's weights (``convert.params_from_jax``), gives
  the JAX engine's tokens.
* The two thread-safety repairs in ``kernels.build``: launch counts of a
  capture on one thread stay apart from another thread's launches and
  credits, and concurrent first binds build once (a stubbed build: no
  ``nvcc`` here).

Every wait on the wall clock is bounded (120 s), so a hang fails its test
instead of the run.
"""
import ctypes
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.core import profiler as prof
from repro_torch.core.api import QueryPayload, QuerySpec
from repro_torch.core.master import MasterConfig
from repro_torch.core.worker import ExecRequest
from repro_torch.kernels import build
from repro_torch.serving.executor import EngineExecutorConfig
from repro_torch.serving.faults import FaultInjector, InjectedFault
from repro_torch.serving.runtime import ServingRuntime, ThreadedEngineExecutor
from repro_torch.sim.clock import RealClock
from repro_torch.sim.cluster import make_cluster

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

LLAMA = ARCHS["llama3.2-1b"]
WAIT = 120.0            # bound of every wall-clock wait
GEO = dict(max_batch=4, max_len=48, decode_block=4)


def _done(q):
    return q.finish >= 0 and not q.failed


def _wall_cluster(n_accel=1, **kw):
    return make_cluster(n_accel=n_accel, archs=[LLAMA], autoscale=False,
                        backend="real", clock="wall",
                        engine_cfg=EngineExecutorConfig(**GEO, **kw),
                        device="cpu", reduced=True)


def _spec(rng, n_prompts=1, max_new=10, latency_ms=600_000, lo=4, hi=12):
    vocab = LLAMA.reduced().vocab
    prompts = [rng.integers(0, vocab, size=int(rng.integers(lo, hi))
                            ).astype(np.int32) for _ in range(n_prompts)]
    return QuerySpec.arch(LLAMA.name, latency_ms=latency_ms,
                          payload=QueryPayload.of(prompts,
                                                  max_new_tokens=max_new))


def _cpu_variant():
    return next(v for v in prof.generate_variants(LLAMA)
                if v.hardware in ("cpu-host", "h100-1"))


def _threaded(**kw):
    return ThreadedEngineExecutor({LLAMA.name: LLAMA.reduced()},
                                  EngineExecutorConfig(**GEO, **kw),
                                  device="cpu")


def _streamed_equals_outputs(h, res):
    for idx, out in enumerate(res.outputs):
        cat = [t for ch in h.chunks if ch.input_idx == idx
               for t in ch.tokens]
        assert cat == [int(x) for x in out], \
            "streamed concat != result() outputs"


# ----------------------------------------------------------------------
# mirrors of tests/test_runtime_wall.py


def test_wall_clock_requires_real_backend():
    with pytest.raises(ValueError, match="backend='real'"):
        make_cluster(n_accel=1, archs=[LLAMA], clock="wall")
    with pytest.raises(ValueError, match="clock"):
        make_cluster(n_accel=1, archs=[LLAMA], clock="lunar")


def test_runtime_rejects_virtual_cluster():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    with pytest.raises(ValueError, match="wall"):
        ServingRuntime(c)


def test_threaded_executor_disables_engine_eviction():
    """LRU engine eviction assumes idle engines between jobs; a threaded
    executor's engines hold in-flight slots, so the cap is lifted."""
    ex = ThreadedEngineExecutor({LLAMA.name: LLAMA.reduced()},
                                EngineExecutorConfig(max_engines=2),
                                device="cpu")
    assert ex.cfg.max_engines is None
    ex.shutdown()


def test_wall_end_to_end_streaming():
    """Live submission: tokens stream as segments retire, the streamed
    concat is ``result().outputs`` exactly, TTFT lands at or before
    completion, and shutdown drains clean with the stepper joined."""
    c = _wall_cluster()
    assert isinstance(c.loop, RealClock)
    assert all(isinstance(ex, ThreadedEngineExecutor) and ex.cfg.stream
               for ex in c.executors)
    rt = ServingRuntime(c)
    try:
        rng = np.random.default_rng(0)
        handles = [rt.submit(_spec(rng, n_prompts=2)) for _ in range(4)]
        # iter_tokens on a live handle blocks on its condition variable
        it_chunks = list(handles[0].iter_tokens(timeout=WAIT))
        results = [h.result(timeout=WAIT) for h in handles]
        assert all(r.ok for r in results), \
            [(r.failed, r.variant) for r in results]
        assert it_chunks and [c_.t for c_ in it_chunks] == \
            sorted(c_.t for c_ in it_chunks)
        for h, r in zip(handles, results):
            assert h.chunks, "no streamed chunks"
            _streamed_equals_outputs(h, r)
            assert h.ttft is not None
            assert 0.0 <= h.ttft <= r.latency + 1e-9
    finally:
        assert rt.shutdown(drain=True, timeout=60.0)
    assert not any(ex._thread.is_alive() for ex in c.executors
                   if ex._thread is not None)


def test_wall_worker_hang_mid_stream_retries_and_streams_exact():
    """A worker that hangs mid-stream strands its in-flight query until the
    heartbeat sweep fires; the retry lands on the surviving worker and the
    streamed concat still equals the final outputs (each attempt streams
    from token 0 and the handle trims the replayed prefix). At reduced
    width on the CPU a query takes tens of ms, so every step of this
    cluster sleeps 50 ms (``slow_step``): the hang lands mid-query."""
    c = _wall_cluster(n_accel=2, faults=FaultInjector(
        rates={"slow_step": 1.0}, slow_step_s=0.05))
    rt = ServingRuntime(c)
    try:
        h = rt.submit(_spec(np.random.default_rng(7), max_new=12))
        victim = None
        deadline = time.monotonic() + WAIT
        while victim is None and time.monotonic() < deadline:
            busy = [n for n, w in c.master.workers.items()
                    if any(li.pending or li.outstanding
                           for li in w.instances.values())]
            victim = busy[0] if busy else None
            time.sleep(0.01)
        assert victim is not None, "query never reached a worker"
        c.master.workers[victim].hang()
        res = h.result(timeout=WAIT)
        assert res.ok, (res.failed, res.variant)
        assert res.attempts > 1, "hang never forced a retry"
        assert not c.store.workers[victim].alive, \
            "heartbeat sweep missed the hung worker"
        _streamed_equals_outputs(h, res)
    finally:
        rt.shutdown(drain=True, timeout=60.0)


def test_wall_submit_rejects_oversized_prompt():
    """A rejected job surfaces as a failed query, not a hung handle: the
    stepper validates before submitting and reports through on_done."""
    c = _wall_cluster()
    rt = ServingRuntime(c)
    try:
        too_long = np.arange(60, dtype=np.int32) % LLAMA.reduced().vocab
        h = rt.submit(QuerySpec.arch(
            LLAMA.name, latency_ms=600_000,
            payload=QueryPayload.of([too_long], max_new_tokens=4)))
        res = h.result(timeout=WAIT)
        assert res.failed and not res.ok
    finally:
        rt.shutdown(drain=True, timeout=60.0)


def test_threaded_executor_two_thread_stress():
    """Two threads hammer ``run_async`` while the stepper drains: every job
    completes exactly once, every request's outputs are delivered exactly
    once, nothing is lost or duplicated."""
    ex = _threaded(stream=True)
    variant = _cpu_variant()
    vocab = LLAMA.reduced().vocab
    n_per_thread = 8
    lock = threading.Lock()
    done = []          # (key, duration, error)
    outputs = {}       # key -> delivery count

    def hammer(tid):
        rng = np.random.default_rng(tid)
        for j in range(n_per_thread):
            key = (tid, j)

            def on_outputs(outs, key=key):
                with lock:
                    outputs[key] = outputs.get(key, 0) + 1

            def on_done(duration, error=None, key=key):
                with lock:
                    done.append((key, duration, error))

            prompt = rng.integers(0, vocab, size=int(rng.integers(4, 10)))
            er = ExecRequest(n_inputs=1,
                             prompts=(tuple(int(x) for x in prompt),),
                             max_new_tokens=int(rng.integers(2, 8)),
                             on_outputs=on_outputs)
            ex.run_async(variant, 1, [er], on_done)

    threads = [threading.Thread(target=hammer, args=(tid,))
               for tid in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    ex.shutdown(timeout=WAIT)      # drains every queued job before stopping
    total = 2 * n_per_thread
    assert len(done) == total, f"lost/duplicated completions: {done}"
    assert all(err is None for _, _, err in done), done
    assert len({key for key, _, _ in done}) == total, "duplicate on_done"
    assert set(outputs) == {(t, j) for t in range(2)
                            for j in range(n_per_thread)}
    assert all(n == 1 for n in outputs.values()), "outputs delivered twice"
    assert not ex._active and not ex._sinks and not ex._req_job
    assert not ex._thread.is_alive()


def test_cobatched_jobs_split_occupancy():
    """Two jobs co-batched on one engine split each shared segment's
    occupancy by live-slot share: the per-job deltas are fractions that
    conserve the engine's raw counters."""
    ex = _threaded()
    variant = _cpu_variant()
    vocab = LLAMA.reduced().vocab
    rng = np.random.default_rng(0)
    done = threading.Event()
    finished = []

    def on_done(duration, error=None):
        finished.append((duration, error))
        if len(finished) == 2:
            done.set()

    def job():
        prompts = tuple(tuple(int(x) for x in rng.integers(0, vocab, size=6))
                        for _ in range(2))
        return [ExecRequest(n_inputs=2, prompts=prompts, max_new_tokens=12)]

    # both queued before the stepper drains its queue: they co-batch
    ex.run_async(variant, 2, job(), on_done)
    ex.run_async(variant, 2, job(), on_done)
    assert done.wait(WAIT)
    ex.shutdown(timeout=60.0)
    assert all(err is None for _, err in finished), finished
    eng = ex.engines[variant.name]
    recs = list(ex.occupancy_log)
    assert len(recs) == 2
    assert sum(r["segments"] for r in recs) == \
        pytest.approx(eng.stats["decode_dispatches"])
    assert sum(r["bubble_slot_steps"] for r in recs) == \
        pytest.approx(eng.stats["bubble_slot_steps"])
    assert all(r["segments"] > 0 for r in recs)
    assert all(r["segments"] < eng.stats["decode_dispatches"]
               for r in recs)


# ----------------------------------------------------------------------
# mirrors of tests/test_faults.py: the injector (pure)


def test_injector_schedule_is_exact_and_seeded_rates_replay():
    def mk():
        return FaultInjector(seed=42, schedule={"s": [2, 5]},
                             rates={"r": 0.3})

    a, b = mk(), mk()
    pat_a = [(a.fire("s"), a.fire("r")) for _ in range(30)]
    pat_b = [(b.fire("s"), b.fire("r")) for _ in range(30)]
    assert pat_a == pat_b, "same seed+schedule must replay bit-for-bit"
    assert [i + 1 for i, (s, _) in enumerate(pat_a) if s] == [2, 5]
    hits = [r for _, r in pat_a]
    assert any(hits) and not all(hits)
    c = a.counts()
    assert c["s"] == {"calls": 30, "fired": 2}
    assert c["r"]["calls"] == 30
    assert not any(a.fire("quiet") for _ in range(50))
    # schedule-only consults don't consume the rated stream
    d = FaultInjector(seed=42, rates={"r": 0.3})
    assert [d.fire("r") for _ in range(30)] == hits


def test_injector_check_raises_typed_fault():
    f = FaultInjector(schedule={"x": [1]})
    with pytest.raises(InjectedFault, match="site 'x'") as ei:
        f.check("x")
    assert ei.value.site == "x"
    f.check("x")                     # consult 2: silent
    assert f.counts()["x"] == {"calls": 2, "fired": 1}


# worker-level sites and the circuit breaker (sim cluster, virtual clock)


@pytest.mark.parametrize("site", ["worker_crash", "worker_hang"])
def test_injected_worker_failure_retries_elsewhere(site):
    """A monitor-daemon crash or hang on one of two workers fails (or
    strands, until the heartbeat sweep notices) its queries; every one
    re-dispatches to the survivor and completes."""
    inj = FaultInjector(schedule={site: [5]})
    cfg = MasterConfig()
    cfg.worker.faults = inj
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False, cfg=cfg)
    c.api.online_query(mod_arch=LLAMA.name, latency_ms=10_000)
    c.run_until(6.0)                 # < 5 monitor consults: nobody dead yet
    qs = [c.api.online_query(mod_arch=LLAMA.name, latency_ms=60_000)
          for _ in range(32)]
    c.run_until(240.0)
    assert inj.fired.get(site) == 1
    dead = [n for n, st in c.store.workers.items() if not st.alive]
    assert len(dead) == 1, "exactly one worker should have been killed"
    done = [q for q in qs if _done(q)]
    assert len(done) == len(qs), \
        f"{len(done)}/{len(qs)} completed after injected {site}"


def _warm_cluster(cfg):
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False, cfg=cfg)
    c.api.online_query(mod_arch=LLAMA.name, latency_ms=10_000)
    c.run_until(30.0)
    return c


def test_breaker_trips_at_threshold_and_routes_around():
    cfg = MasterConfig(breaker_enabled=True, breaker_fail_threshold=3,
                       breaker_cooldown=1e9)
    c = _warm_cluster(cfg)
    m = c.master
    victim, other = sorted(m.workers)[:2]
    for _ in range(2):
        m._breaker_failure(victim)
        assert not c.store.workers[victim].blacklisted
    m._breaker_failure(victim)       # third consecutive failure trips
    assert c.store.workers[victim].blacklisted
    assert m.breaker_events[-1][1:] == (victim, "open")
    assert m._breakers[victim].trips == 1
    m._breaker_failure(victim)       # open swallows further signals
    assert m._breakers[victim].trips == 1
    m._breaker_failure(other)
    m._breaker_failure(other)
    m._breaker_success(other)
    assert m._breakers[other].failures == 0
    assert not c.store.workers[other].blacklisted
    t0 = c.loop.now()
    qs = [c.api.online_query(mod_arch=LLAMA.name, latency_ms=60_000)
          for _ in range(8)]
    c.run_until(t0 + 120.0)
    assert all(_done(q) for q in qs)
    assert all(q.worker != victim for q in qs), \
        "query dispatched to a breaker-open worker"


def test_breaker_halfopen_probe_cycle():
    """open -> (cooldown) -> half-open -> probe failure -> open ->
    (cooldown) -> half-open -> probe success -> closed, the blacklist
    flag tracking exactly the open state."""
    cfg = MasterConfig(breaker_enabled=True, breaker_fail_threshold=1,
                       breaker_cooldown=5.0)
    c = _warm_cluster(cfg)
    m = c.master
    victim = sorted(m.workers)[0]
    m._breaker_failure(victim)
    assert m._breakers[victim].state == "open"
    assert c.store.workers[victim].blacklisted
    c.run_until(c.loop.now() + 30.0)
    assert m._breakers[victim].state == "half-open"
    assert not c.store.workers[victim].blacklisted
    m._breaker_failure(victim)
    assert m._breakers[victim].state == "open"
    assert c.store.workers[victim].blacklisted
    assert m._breakers[victim].trips == 2
    c.run_until(c.loop.now() + 30.0)
    assert m._breakers[victim].state == "half-open"
    m._breaker_success(victim)
    assert m._breakers[victim].state == "closed"
    assert not c.store.workers[victim].blacklisted
    assert [s for _, n, s in m.breaker_events if n == victim] == \
        ["open", "half-open", "open", "half-open", "closed"]


def test_breaker_pressure_and_staleness_signals():
    """The sweep folds data-plane pressure deltas (the executor's monotone
    preemption + stall total since the last sweep) and sub-timeout
    heartbeat staleness into failure signals; folded pressure never
    re-counts."""
    cfg = MasterConfig(breaker_enabled=True, breaker_fail_threshold=2,
                       breaker_pressure_threshold=8, breaker_cooldown=1e9)
    c = _warm_cluster(cfg)
    m = c.master
    victim = sorted(m.workers)[0]
    w = m.workers[victim]
    w.executor.pressure_events_total = 9.0   # delta 9 >= 8
    m._breaker_sweep(c.loop.now())
    assert m._breakers[victim].failures == 1
    m._breaker_sweep(c.loop.now())       # no new pressure: no new signal
    assert m._breakers[victim].failures == 1
    w.executor.pressure_events_total += 8.0
    m._breaker_sweep(c.loop.now())       # second signal trips
    assert m._breakers[victim].state == "open"
    other = sorted(m.workers)[1]
    c.store.workers[other].heartbeat = \
        c.loop.now() - 0.6 * cfg.heartbeat_timeout
    m._breaker_sweep(c.loop.now())
    assert m._breakers[other].failures == 1


# wall-clock chaos: stepper death, a dispatch fault, deadline enforcement


def test_stepper_death_fails_inflight_into_retry():
    """An injected stepper death mid-decode fails the in-flight job through
    on_done (master retry), the thread restarts with its engines dropped,
    and the retried query completes with a direct engine's tokens."""
    faults = FaultInjector(schedule={"stepper": [2]})
    c = _wall_cluster(faults=faults)
    rt = ServingRuntime(c)
    try:
        spec = _spec(np.random.default_rng(0))
        h = rt.submit(spec)
        res = h.result(timeout=WAIT)
        assert res.ok, (res.failed, res.variant)
        assert res.attempts > 1, "query never went around the retry loop"
        assert faults.fired.get("stepper") == 1
        assert sum(ex.stepper_restarts for ex in c.executors) == 1
        (ex,) = c.executors
        variant = c.store.registry.variants[res.variant]
        want = _direct_tokens(ex, variant, spec.payload.prompts,
                              spec.payload.max_new_tokens)
        for a, b in zip(want, res.outputs):
            np.testing.assert_array_equal(a, b)
    finally:
        rt.shutdown(drain=True, timeout=60.0)


def test_dispatch_fault_retries_to_completion():
    faults = FaultInjector(schedule={"dispatch": [1]})
    c = _wall_cluster(faults=faults)
    rt = ServingRuntime(c)
    try:
        h = rt.submit(_spec(np.random.default_rng(1)))
        res = h.result(timeout=WAIT)
        assert res.ok and res.attempts > 1
        assert faults.fired.get("dispatch") == 1
    finally:
        rt.shutdown(drain=True, timeout=60.0)


def test_deadline_enforce_surfaces_timed_out_verdict():
    """A 1 ms SLO cannot survive the first decode step: the stepper cancels
    the slot between steps, the verdict rides executor -> worker -> api,
    and the handle resolves (not failed) with timed_out=True."""
    c = _wall_cluster(deadline_enforce=True)
    rt = ServingRuntime(c)
    try:
        h = rt.submit(_spec(np.random.default_rng(2), max_new=30,
                            latency_ms=1))
        res = h.result(timeout=WAIT)
        assert res.timed_out is True
        assert not res.failed, "timeout is a verdict, not a failure"
        h2 = rt.submit(_spec(np.random.default_rng(3)))
        res2 = h2.result(timeout=WAIT)
        assert res2.ok and res2.timed_out is False
    finally:
        rt.shutdown(drain=True, timeout=60.0)


# ----------------------------------------------------------------------
# parity with the JAX package's engine


def _direct_tokens(ex, variant, prompts, max_new):
    """Tokens of a fresh port engine on the variant's served params, with
    the executor engine's geometry."""
    from repro_torch.serving.engine import Request, ServingEngine
    model, params = ex.served_model(variant)
    eng = ServingEngine(model, params, max_batch=min(
        GEO["max_batch"], variant.profile.max_batch), max_len=GEO["max_len"],
        decode_block=GEO["decode_block"], min_bucket=4, page_size=16)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.tokens for r in reqs]


def test_wall_clock_tokens_equal_jax_engine():
    """Streamed payload queries for the bf16 and the int8 variant, in
    flight together on one stepper: each query's tokens equal the JAX
    engine's on the same weights (the JAX init, and its int8 tree,
    carried by ``convert.params_from_jax``), and its streamed concat
    equals its outputs."""
    import dataclasses

    import jax
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro.models import build_model as j_build
    from repro.models.quantize import quantize_params_dense as j_quant
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model as t_build

    jcfg = J_ARCHS[LLAMA.name].reduced()
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jqm = j_build(dataclasses.replace(jcfg, quantize="int8"))
    jqp = j_quant(jp)
    c = _wall_cluster()
    (ex,) = c.executors
    tcfg = LLAMA.reduced()
    ex._models[LLAMA.name] = (t_build(tcfg, "cpu"),
                              params_from_jax(jp, device="cpu"))
    ex._models[f"{LLAMA.name}::int8"] = (
        t_build(dataclasses.replace(tcfg, quantize="int8"), "cpu"),
        params_from_jax(jqp, device="cpu"))
    rng = np.random.default_rng(11)
    vocab = tcfg.vocab
    runs = []
    rt = ServingRuntime(c)
    try:
        for dtype in ("bf16", "int8"):
            prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
                       for n in rng.integers(3, 20, size=3)]
            h = rt.submit(QuerySpec.variant(
                f"{LLAMA.name}/h100-1/{dtype}-b8", latency_ms=600_000,
                payload=QueryPayload.of(prompts, max_new_tokens=9)))
            runs.append((dtype, prompts, h))
        for dtype, prompts, h in runs:
            res = h.result(timeout=WAIT)
            assert res.ok and res.variant.endswith(f"{dtype}-b8")
            _streamed_equals_outputs(h, res)
            model, params = (jm, jp) if dtype == "bf16" else (jqm, jqp)
            eng = JEngine(model, params, max_batch=4, max_len=48,
                          decode_block=4, min_bucket=4)
            reqs = [JRequest(rid=i, prompt=p, max_new_tokens=9)
                    for i, p in enumerate(prompts)]
            eng.serve(reqs)
            for want, got in zip(reqs, res.outputs):
                np.testing.assert_array_equal(np.asarray(want.tokens), got)
    finally:
        assert rt.shutdown(drain=True, timeout=60.0)


# ----------------------------------------------------------------------
# kernels.build under threads (no nvcc: counters and a stubbed build)


def test_capture_tally_is_per_thread_and_totals_exact():
    """While one thread records a capture, eight others' launches and
    credits go to the shared totals, never into the capture's tally: the
    tally holds exactly the capturing thread's launches and the totals
    lose no update (the interpreter switches threads every microsecond)."""
    build.reset_launch_counts()
    n, k = 2000, 8
    go = threading.Barrier(k + 1)
    out = {}

    def capturer():
        with build.capturing() as tally:
            go.wait()
            for _ in range(n):
                build.check_launch("flash_attention", 0)
                build.check_launch("int8_matmul", 0)
        out["tally"] = dict(tally)

    def other():
        go.wait()
        for _ in range(n):
            build.check_launch("flash_attention", 0)
            build.credit({"int8_matmul": 2, "decode_attention": 1}, 3)

    threads = [threading.Thread(target=f)
               for f in (capturer, *[other] * k)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert out["tally"] == {"flash_attention": n, "int8_matmul": n}
    assert build.launch_counts["flash_attention"] == k * n
    assert build.launch_counts["int8_matmul"] == 6 * k * n
    assert build.launch_counts["decode_attention"] == 3 * k * n
    build.credit(out["tally"], 2)
    assert build.launch_counts["flash_attention"] == (k + 2) * n
    with pytest.raises(RuntimeError, match="nest"):
        with build.capturing():
            with build.capturing():
                pass
    build.reset_launch_counts()


def test_concurrent_first_binds_build_once(monkeypatch):
    """Eight threads calling a kernel's entry point first at once build
    and load its library once and get one function."""
    calls = {"build": 0, "load": 0}

    def fake_build():
        calls["build"] += 1
        time.sleep(0.05)            # wide enough for a race to show
        return {}

    class FakeLib:
        def __getattr__(self, sym):
            return ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    def fake_cdll(path):
        calls["load"] += 1
        return FakeLib()

    monkeypatch.setattr(build, "_build_all", fake_build)
    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_fns", {})
    got, go = [], threading.Barrier(8)

    def first_call():
        go.wait()
        got.append(build.kernel_fn("flash_attention"))

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(f is got[0] for f in got)
    build.helper_fn("decode_mma_smem_bytes")   # another library: loads once
    assert calls == {"build": 2, "load": 2}
