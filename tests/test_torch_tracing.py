"""The port's program spans (``repro_torch.tracing``) and the engine's
queue-wait and prefill-padding counters, on the CPU, reduced size.

* The store records only while a ``torch.profiler`` records: a wall-clock
  query with no profiler leaves it empty; under one, the stepper's spans of
  a query's job carry the job id the worker gave it on the scheduler
  thread, and spans nest on a thread. The profiler's flag is seen from
  every thread, and the engine's ``perf_counter`` stamps and the store's
  ``monotonic`` ones are one clock. Profiled on the stepper thread, the
  spans name the host's regions in the trace and enclose no operator (no
  device work, which the profiler would project onto the device's
  timeline).
* ``prefill_tokens`` and ``prefill_tokens_padded`` equal a hand count of
  one grouped admission; a query queued behind a running job waits out at
  least the rest of that job (``timing.queue_wait_s``), and the job it
  rode in is named on the query and in the occupancy log.

Every wait on the wall clock is bounded (120 s).
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.registry import ARCHS
from repro_torch.core.api import QueryPayload, QuerySpec
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.executor import EngineExecutorConfig
from repro_torch.serving.runtime import ServingRuntime
from repro_torch.sim.cluster import make_cluster

torch.set_num_threads(1)

LLAMA = ARCHS["llama3.2-1b"]
WAIT = 120.0


@pytest.fixture
def runtime():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False,
                     backend="real", clock="wall",
                     engine_cfg=EngineExecutorConfig(
                         max_batch=4, max_len=64, decode_block=4),
                     device="cpu", reduced=True)
    rt = ServingRuntime(c)
    yield rt
    assert rt.shutdown(drain=True, timeout=60.0)


def _spec(n_prompt=8, max_new=6, seed=0):
    vocab = LLAMA.reduced().vocab
    prompt = np.random.default_rng(seed).integers(
        0, vocab, size=n_prompt).astype(np.int32)
    return QuerySpec.arch(LLAMA.name, latency_ms=600_000,
                          payload=QueryPayload.of([prompt],
                                                  max_new_tokens=max_new))


def _executor(rt):
    (ex,) = rt.cluster.executors
    return ex


def test_no_profiler_records_nothing(runtime):
    t0 = time.monotonic()
    assert runtime.submit(_spec()).result(timeout=WAIT).ok
    runtime.submit(_spec(seed=1)).result(timeout=WAIT)
    assert tracing.spans(t0) == []
    with tracing.span("stepper.admit", job=0):
        pass
    assert tracing.spans(t0) == []


def test_query_spans_share_its_id_across_threads(runtime):
    assert runtime.submit(_spec()).result(timeout=WAIT).ok    # warm
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        h = runtime.submit(_spec(seed=2))
        assert h.result(timeout=WAIT).ok
        # the job's last span may close just after the query's answer is
        # handed over; the idle stepper then waits on its queue
        want = {"stepper.admit", "stepper.finish"}
        deadline = time.monotonic() + WAIT
        while not ("stepper.wait" in {s.name for s in tracing.spans(t0)}
                   and want <= {s.name for s in tracing.spans(t0)
                                if s.job == h.query.job}) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
    q = h.query
    got = tracing.spans(t0)
    assert want <= {s.name for s in got if s.job == q.job >= 0}, got
    names = {s.name for s in got}
    assert {"stepper.wait", "stepper.stream", "engine.harvest"} <= names
    assert all(s.thread == "engine-stepper" for s in got), got
    # the worker named the job on the scheduler thread: the executor's
    # log of that job holds the query's id
    (rec,) = [r for r in _executor(runtime).occupancy_log
              if r["job"] == q.job]
    assert rec["qids"] == [q.qid]


def test_spans_nest_on_a_thread(runtime):
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", job=7):
            with tracing.span("inner"):
                pass
        with tracing.span("after"):
            pass
        assert runtime.submit(_spec(seed=3)).result(timeout=WAIT).ok
    got = tracing.spans(t0)
    by = {s.name: s for s in got}
    assert by["inner"].parent == "outer" and by["outer"].parent is None
    assert by["after"].parent is None
    assert by["outer"].job == 7 and by["inner"].job is None
    assert by["outer"].t_start <= by["inner"].t_start \
        <= by["inner"].t_end <= by["outer"].t_end <= by["after"].t_start
    # the stepper's spans do not enclose one another
    assert all(s.parent is None for s in got
               if s.thread == "engine-stepper"), got


def test_profiler_flag_is_process_wide_and_clocks_are_one():
    import torch.autograd.profiler as P
    seen = {}

    def look():
        seen["flag"] = P._is_profiler_enabled
        with tracing.span("elsewhere"):
            pass

    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU]):
        th = threading.Thread(target=look)
        th.start()
        th.join(WAIT)
    assert not th.is_alive()
    assert seen["flag"] is True and P._is_profiler_enabled is False
    assert [s.name for s in tracing.spans(t0)] == ["elsewhere"]
    pc, mono = time.get_clock_info("perf_counter"), \
        time.get_clock_info("monotonic")
    assert pc.implementation == mono.implementation
    a, b, c = time.monotonic(), time.perf_counter(), time.monotonic()
    assert a <= b <= c


def test_prefill_token_counts_equal_a_hand_count():
    cfg = LLAMA.reduced()
    model = build_model(cfg, device="cpu")
    eng = ServingEngine(model, model.init(0), max_batch=4, max_len=64,
                        decode_block=4, min_bucket=8)
    rng = np.random.default_rng(5)
    lens = [3, 5, 9, 20]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n)
                    .astype(np.int32), max_new_tokens=2)
            for i, n in enumerate(lens)]
    eng.serve(reqs)
    # buckets 8 (two rows: an admit batch of max_batch 4), 16 and 32 (one
    # row each)
    assert eng.stats["prefill_dispatches"] == 3
    assert eng.stats["prefill_tokens"] == 3 + 5 + 9 + 20
    assert eng.stats["prefill_tokens_padded"] == 4 * 8 + 16 + 32
    # no control-plane arrival: no seat is counted
    assert eng.stats["first_seats"] == 0
    assert eng.timing["queue_wait_s"] == 0.0


def test_spans_enclose_no_device_work(runtime):
    assert runtime.submit(_spec()).result(timeout=WAIT).ok    # warm
    (eng,) = _executor(runtime).engines.values()
    prof = profile(activities=[ProfilerActivity.CPU])
    step, state = eng.step, {}

    def hook():
        # the profiler starts and stops on the stepper thread, between
        # steps, as the benchmark's profiled span does
        if "on" not in state:
            prof.start()
            state["on"] = True
        elif state.get("stop") and "off" not in state:
            prof.stop()
            state["off"] = True
        return step()

    eng.step = hook
    try:
        assert runtime.submit(_spec(seed=6)).result(timeout=WAIT).ok
        state["stop"] = True
        assert runtime.submit(_spec(seed=7)).result(timeout=WAIT).ok
    finally:
        del eng.step
    assert "off" in state
    events = prof.events()
    ours = [e for e in events if e.name.startswith("infaas.")]
    assert {"infaas.stepper.admit", "infaas.stepper.stream",
            "infaas.stepper.finish", "infaas.stepper.wait",
            "infaas.engine.harvest"} <= {e.name for e in ours}, \
        sorted({e.name for e in events})
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    for e in ours:
        inside = [o.name for o in ops if o.thread == e.thread
                  and e.time_range.start <= o.time_range.start
                  and o.time_range.end <= e.time_range.end]
        assert not inside, (e.name, inside)


def test_query_behind_a_running_job_waits_it_out(runtime):
    assert runtime.submit(_spec()).result(timeout=WAIT).ok    # warm
    ex = _executor(runtime)
    (eng,) = ex.engines.values()
    first = threading.Event()
    a = runtime.submit(_spec(max_new=40, seed=4))
    a.on_tokens(lambda ch: first.set())
    assert first.wait(WAIT)
    wait0, seats0 = eng.timing["queue_wait_s"], eng.stats["first_seats"]
    b = runtime.submit(_spec(seed=5))
    assert a.result(timeout=WAIT).ok and b.result(timeout=WAIT).ok
    assert eng.stats["first_seats"] - seats0 == 1
    waited = eng.timing["queue_wait_s"] - wait0
    qa, qb = a.query, b.query
    assert qb.job > qa.job >= 0
    (rec,) = [r for r in ex.occupancy_log if r["job"] == qa.job]
    assert rec["qids"] == [qa.qid]
    # b is seated after a's job completed, which stamped a's finish
    mono = runtime.loop.to_monotonic
    assert waited >= mono(qa.finish) - mono(qb.arrival) > 0.0
