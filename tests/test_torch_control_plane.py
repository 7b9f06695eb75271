"""The port's control plane (``repro_torch.core``, ``repro_torch.sim``) on
the CPU: mirrors of the reference's control-plane tests, a trace-for-trace
parity check of the sim backend against ``repro``, and unit tests of what
the port changes (the H100 catalog, ``torch-*`` frameworks, the registry).

The mirrors keep the reference tests' names and bodies; hardware labels
read ``h100-1`` for ``tpu-v5e-1``. None of these tests builds a model.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.configs.registry import ARCHS
from repro_torch.core import profiler as prof
from repro_torch.core.abstraction import Registry
from repro_torch.core.api import (ArchTarget, QueryPayload, QuerySpec,
                                  UseCaseTarget, VariantTarget)
from repro_torch.core.master import MasterConfig
from repro_torch.core.metadata import InstanceState, MetadataStore
from repro_torch.core.selection import VariantSelector
from repro_torch.sim import hardware as HW
from repro_torch.sim.clock import Clock, EventLoop, RealClock
from repro_torch.sim.cluster import make_cluster
from repro_torch.sim.workload import (popularity_split, poisson_arrivals,
                                      zipf_weights)

LLAMA = ARCHS["llama3.2-1b"]


def _done(q):
    return q.finish >= 0 and not q.failed


# ======================================================================
# mirrors tests/test_query_api.py
# The QuerySpec/QueryHandle surface.


def test_spec_constructors_tag_exactly_one_target():
    assert QuerySpec.variant("v").granularity == "variant"
    assert QuerySpec.arch("a", latency_ms=100).granularity == "arch"
    s = QuerySpec.usecase("t", "d", min_accuracy=0.5, latency_ms=100)
    assert s.granularity == "usecase"
    assert s.slo == pytest.approx(0.1)
    assert isinstance(s.target, UseCaseTarget)


def test_spec_rejects_untyped_target():
    with pytest.raises(TypeError):
        QuerySpec(target="llama3.2-1b")          # a bare string is ambiguous
    with pytest.raises(TypeError):
        QuerySpec(target=None)


def test_spec_rejects_bad_mode_and_offline_slo():
    with pytest.raises(ValueError):
        QuerySpec(ArchTarget("a"), mode="batch")
    with pytest.raises(ValueError):
        QuerySpec.arch("a", latency_ms=100, mode="offline")
    # offline without an SLO is fine (paper: no offline latency option)
    QuerySpec.arch("a", mode="offline", n_inputs=10)


def test_spec_slo_units_are_exclusive():
    with pytest.raises(ValueError):
        QuerySpec.arch("a", slo=0.1, latency_ms=100)
    assert QuerySpec.arch("a", slo=0.1).slo == QuerySpec.arch(
        "a", latency_ms=100).slo


def test_payload_n_inputs_consistency():
    p = QueryPayload.of([[1, 2, 3], [4, 5]], max_new_tokens=2)
    assert len(p) == 2
    s = QuerySpec.arch("a", payload=p)           # n_inputs derived
    assert s.n_inputs == 2
    with pytest.raises(ValueError):
        QuerySpec.arch("a", payload=p, n_inputs=3)
    with pytest.raises(ValueError):
        QueryPayload.of([])
    with pytest.raises(ValueError):
        QueryPayload.of([[]])
    with pytest.raises(ValueError):
        QueryPayload.of([[1]], max_new_tokens=0)
    with pytest.raises(ValueError):
        QuerySpec.arch("a", n_inputs=0)


def test_spec_is_immutable_and_hashable():
    s = QuerySpec.usecase("t", "d", payload=QueryPayload.of([[1, 2]]))
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.mode = "offline"
    assert hash(s) == hash(QuerySpec.usecase(
        "t", "d", payload=QueryPayload.of([[1, 2]])))


def test_result_pumps_the_event_loop():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=5000))
    assert not h.done
    res = h.result(timeout=60.0)                 # no run_until by the test
    assert h.done and res.ok and not res.failed
    assert c.loop.now() > 0.0                    # the loop really advanced
    assert res.latency == pytest.approx(h.query.latency)
    # breakdown partitions the latency exactly
    assert res.queue + res.load + res.compute == pytest.approx(res.latency)
    assert res.load > 0.0                        # cold query paid the load
    assert res.compute > 0.0
    assert res.slo_met is True


def test_result_timeout_raises_and_preserves_deadline():
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=5000))
    with pytest.raises(TimeoutError):
        h.result(timeout=0.3)                    # retries outlive this
    assert c.loop.now() <= 0.3 + 1e-9            # did not overshoot


def test_slo_verdict_violated():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    # impossible SLO: even the fastest variant's load alone exceeds it
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=0.001))
    res = h.result(timeout=120.0)
    assert res.ok and res.slo_met is False
    # no-SLO query has no verdict
    h2 = c.api.submit(QuerySpec.variant(res.variant))
    assert h2.result(timeout=60.0).slo_met is None


def test_done_callbacks_fire_in_order_and_immediately_after():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=5000))
    order = []
    h.add_done_callback(lambda hh: order.append("first"))
    h.add_done_callback(lambda hh: order.append("second"))
    h.result(timeout=60.0)
    assert order == ["first", "second"]
    h.add_done_callback(lambda hh: order.append("late"))
    assert order == ["first", "second", "late"]  # already done -> immediate


def test_failed_query_resolves_handle():
    cfg = MasterConfig(max_retries=1, retry_delay=0.05)
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False,
                     cfg=cfg)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=5000))
    res = h.result(timeout=30.0)
    assert res.failed and not res.ok


def _drive(c, use_spec: bool):
    vname = next(v.name for v in c.store.registry.variants.values()
                 if v.hardware == "h100-1")
    if use_spec:
        qs = [
            c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=5000)).query,
            c.api.submit(QuerySpec.usecase(
                "text-generation", "openwebtext", min_accuracy=0.5,
                latency_ms=5000)).query,
            c.api.submit(QuerySpec.variant(vname, latency_ms=5000)).query,
        ]
    else:
        qs = [
            c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000),
            c.api.online_query(task="text-generation",
                               dataset="openwebtext", accuracy=0.5,
                               latency_ms=5000),
            c.api.online_query(mod_var=vname, latency_ms=5000),
        ]
    c.run_until(120.0)
    return qs


def test_shims_match_specs_for_all_granularities():
    results = {}
    for use_spec in (False, True):
        c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
        qs = _drive(c, use_spec)
        assert all(_done(q) for q in qs)
        results[use_spec] = (
            [q.variant for q in qs],
            [q.latency for q in qs],
            [m for m, _, _ in c.master.decision_log],
        )
    # identical selections, latencies, and decision modes
    assert results[False][0] == results[True][0]
    assert results[False][1] == pytest.approx(results[True][1])
    assert results[False][2] == results[True][2] \
        == ["modarch", "usecase", "modvar"]


def test_shim_offline_matches_spec_offline():
    done_counts = {}
    for use_spec in (False, True):
        c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
        if use_spec:
            job = c.api.submit(QuerySpec.arch(LLAMA.name, mode="offline",
                                              n_inputs=64)).job
        else:
            job = c.api.offline_query(mod_arch=LLAMA.name, n_inputs=64)
        c.run_until(120.0)
        done_counts[use_spec] = job.processed
        assert job.processed > 0
    assert done_counts[False] == done_counts[True]


def test_shim_done_cb_receives_query_and_job():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    seen = []
    q = c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000,
                           done_cb=lambda qq: seen.append(qq))
    j = c.api.offline_query(mod_arch=LLAMA.name, n_inputs=8,
                            done_cb=lambda jj: seen.append(jj))
    c.run_until(120.0)
    assert q in seen and j in seen


def test_hedge_duplicate_preserves_spec_fields():
    cfg = MasterConfig(hedge_enabled=True, hedge_factor=2.0)
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False, cfg=cfg)
    c.master.add_worker("accel", name="straggler", slowdown=25.0)
    v = [x for x in c.store.registry.variants.values()
         if x.hardware == "h100-1" and x.batch_opt == 8
         and "bf16" in x.framework][0]
    for w in c.master.workers.values():
        w.load_variant(v)
    # stay inside the T_accel scale-down hysteresis so both instances are
    # still resident when the hedge looks for a backup
    c.run_until(10.0)
    # a use-case query from a named tenant, routed to the straggler
    spec = QuerySpec.usecase("text-generation", "openwebtext",
                             min_accuracy=0.5, slo=30.0, user="tenantX")
    q = c.master._query_from_spec(spec, arrival=c.loop.now())
    straggler = c.master.workers["straggler"]
    sel = type("S", (), {"variant": v, "worker": "straggler",
                         "needs_load": False})()
    straggler.enqueue(q, v.name)
    c.master._arm_hedge(q, sel)
    c.run_until(300.0)
    assert _done(q)
    dups = [m for m in c.master.metrics if m.hedge_of == q.qid]
    assert dups, "hedge never fired"
    d = dups[0]
    # pre-fix, the duplicate dropped everything but arch/slo
    assert d.task == "text-generation" and d.dataset == "openwebtext"
    assert d.min_accuracy == pytest.approx(0.5)
    assert d.user == "tenantX"
    assert d.spec is q.spec
    assert d.n_inputs == q.n_inputs and d.slo == q.slo
    # the duplicate actually served on the selected variant
    assert _done(d) and d.variant == v.name


def test_hedged_usecase_query_via_submit_path():
    """End-to-end: hedging armed by the normal submit path on a use-case
    spec keeps the duplicate faithful."""
    cfg = MasterConfig(hedge_enabled=True, hedge_factor=2.0)
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False, cfg=cfg)
    v = [x for x in c.store.registry.variants.values()
         if x.hardware == "h100-1" and x.batch_opt == 8
         and "bf16" in x.framework][0]
    for w in c.master.workers.values():
        w.load_variant(v)
    c.run_until(10.0)
    h = c.api.submit(QuerySpec.usecase(
        "text-generation", "openwebtext", min_accuracy=0.5, slo=30.0,
        user="tenantY"))
    c.run_until(300.0)
    assert h.done
    for d in (m for m in c.master.metrics if m.hedge_of is not None):
        assert d.task and d.user != "public"


def test_offline_query_retries_until_capacity_appears():
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, mode="offline",
                                    n_inputs=32))
    job = h.job
    # capacity appears only after the job has started retrying
    c.loop.schedule(0.6, lambda: c.master.add_worker("accel"))
    res = h.result(timeout=600.0)
    assert res.ok and not job.failed
    assert job.processed >= job.total_inputs
    assert job.variant


def test_offline_query_shim_retries_too():
    """Regression: the kwargs shim used to return an inert OfflineJob when
    nothing could serve it yet."""
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False)
    job = c.api.offline_query(mod_arch=LLAMA.name, n_inputs=16)
    c.loop.schedule(0.6, lambda: c.master.add_worker("accel"))
    c.run_until(600.0)
    assert job.done and job.processed >= 16


def test_offline_query_fails_after_max_retries():
    cfg = MasterConfig(max_retries=2, retry_delay=0.05)
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False,
                     cfg=cfg)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, mode="offline",
                                    n_inputs=8))
    res = h.result(timeout=60.0)
    assert res.failed and h.job.failed
    assert h.job not in c.master.offline_done


def test_usecase_spec_redispatch_reselects():
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.usecase(
        "text-generation", "openwebtext", min_accuracy=0.5,
        latency_ms=600_000))
    c.loop.schedule(0.6, lambda: c.master.add_worker("accel"))
    res = h.result(timeout=600.0)
    assert res.ok and res.variant
    assert isinstance(h.spec.target, UseCaseTarget)


def test_variant_spec_redispatch_pins_variant():
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False)
    vname = next(v.name for v in c.store.registry.variants.values()
                 if v.hardware == "h100-1")
    h = c.api.submit(QuerySpec.variant(vname, latency_ms=600_000))
    c.loop.schedule(0.6, lambda: c.master.add_worker("accel"))
    res = h.result(timeout=600.0)
    assert res.ok and res.variant == vname
    assert isinstance(h.spec.target, VariantTarget)


def test_result_is_snapshotted_at_completion():
    """A losing hedge copy finishing later mutates the raw Query; the
    handle must keep reporting the values it completed with."""
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=5000))
    res = h.result(timeout=60.0)
    finish0, lat0 = h.query.finish, res.latency
    h.query.finish = finish0 + 100.0     # straggler overwrites the Query
    h.query.violated = True
    again = h.result(timeout=1.0)
    assert again.latency == pytest.approx(lat0)
    assert again.slo_met is True


def test_failed_hedge_duplicate_does_not_complete_original():
    """A hedge duplicate that dies on enqueue (instance gone between the
    store lookup and the worker) must not resolve the original's handle
    with bogus negative-latency state."""
    cfg = MasterConfig(hedge_enabled=True, hedge_factor=2.0)
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False, cfg=cfg)
    v = [x for x in c.store.registry.variants.values()
         if x.hardware == "h100-1" and x.batch_opt == 8
         and "bf16" in x.framework][0]
    workers = list(c.master.workers.values())
    for w in workers:
        w.load_variant(v)
    c.run_until(10.0)
    spec = QuerySpec.usecase("text-generation", "openwebtext",
                             min_accuracy=0.5, slo=30.0)
    q = c.master._query_from_spec(spec, arrival=c.loop.now())
    h_done = []
    q.done_cb = lambda qq: h_done.append(qq.finish)
    sel = type("S", (), {"variant": v, "worker": workers[0].name,
                         "needs_load": False})()
    workers[0].enqueue(q, v.name)
    c.master._arm_hedge(q, sel)
    # the backup's local instance vanishes while the store still lists it
    # running: the duplicate's enqueue will fail immediately
    workers[1].instances.pop(v.name)
    c.run_until(120.0)
    assert _done(q)
    assert q.finish >= 0 and q.latency > 0       # not the dup's -1 finish
    assert h_done and h_done[0] >= 0


def test_offline_load_failure_reenters_retry_loop():
    """If the chosen worker cannot load the variant (stale memory
    accounting), the job must keep retrying — not park forever on a
    worker that will never host it."""
    cfg = MasterConfig(max_retries=3, retry_delay=0.1)
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False, cfg=cfg)
    w = next(iter(c.master.workers.values()))
    w.load_variant = lambda *a, **k: False       # device "full" forever
    h = c.api.submit(QuerySpec.arch(LLAMA.name, mode="offline",
                                    n_inputs=8))
    res = h.result(timeout=60.0)                 # resolves: fails cleanly
    assert res.failed and h.job.failed
    assert h.job not in w.offline_jobs


def _streaming_handle():
    from repro_torch.core.api import QueryHandle
    spec = QuerySpec.arch(LLAMA.name,
                          payload=QueryPayload.of([[1, 2, 3]],
                                                  max_new_tokens=8))
    return QueryHandle(spec, loop=None)


def test_push_tokens_cursor_drops_resent_prefix():
    """A retry regenerates from token 0; chunks whose offsets the handle
    already delivered are dropped (whole or trimmed), so the concat of
    delivered chunks holds each token exactly once."""
    h = _streaming_handle()
    h._push_tokens(0, [10, 11, 12], 0.1, start=0)
    h._push_tokens(0, [13, 14], 0.2, start=3)
    # attempt 2 (new worker) re-streams from scratch, then passes the
    # first attempt's frontier mid-chunk
    h._push_tokens(0, [10, 11, 12], 0.3, start=0)      # fully re-sent
    h._push_tokens(0, [13, 14, 15, 16], 0.4, start=3)  # overlaps by 2
    h._push_tokens(0, [17], 0.5, start=7)
    cat = [t for ch in h.chunks if ch.input_idx == 0 for t in ch.tokens]
    assert cat == [10, 11, 12, 13, 14, 15, 16, 17]


def test_push_tokens_cursor_is_per_input():
    h = _streaming_handle()
    h._push_tokens(0, [1, 2], 0.1, start=0)
    h._push_tokens(1, [7, 8, 9], 0.1, start=0)   # input 1: own cursor
    h._push_tokens(1, [7, 8, 9], 0.2, start=0)   # re-sent: dropped
    h._push_tokens(0, [3], 0.2, start=2)
    assert [t for c in h.chunks if c.input_idx == 0
            for t in c.tokens] == [1, 2, 3]
    assert [t for c in h.chunks if c.input_idx == 1
            for t in c.tokens] == [7, 8, 9]


def test_push_tokens_legacy_no_offset_appends():
    """start=None callers keep the pre-cursor append-everything
    behavior (no silent dedup where offsets were never provided)."""
    h = _streaming_handle()
    h._push_tokens(0, [1, 2], 0.1)
    h._push_tokens(0, [1, 2], 0.2)
    assert len(h.chunks) == 2


def test_worker_token_wrapper_offsets_reset_per_attempt():
    """Each dispatch attempt counts emission offsets from 0 (the engine
    regenerates deterministically), so a master retry to a *different
    worker* after a partial stream re-sends the prefix with the right
    offsets and the handle suppresses it."""
    from types import SimpleNamespace
    from repro_torch.core.worker import Query, Worker

    h = _streaming_handle()
    q = Query(qid=1, kind="online", n_inputs=1, slo=None, arrival=0.0,
              payload=h.spec.payload, spec=h.spec)
    q.on_tokens = h._push_tokens

    def attempt(now):
        w = object.__new__(Worker)       # only .loop is touched here
        w.loop = SimpleNamespace(now=lambda: now)
        return w._exec_request(q)

    er1 = attempt(1.0)                   # worker A: streams 5, then dies
    er1.on_tokens(0, [10, 11, 12], 0.0)
    er1.on_tokens(0, [13, 14], 0.0)
    er2 = attempt(2.0)                   # worker B: full regeneration
    er2.on_tokens(0, [10, 11, 12], 0.0)
    er2.on_tokens(0, [13, 14, 15], 0.0)
    er2.on_tokens(0, [16, 17], 0.0)
    cat = [t for ch in h.chunks if ch.input_idx == 0 for t in ch.tokens]
    assert cat == [10, 11, 12, 13, 14, 15, 16, 17]
    assert q.first_token == 1.0          # TTFT pinned to the first attempt

# ======================================================================
# mirrors tests/test_core_selection.py
# Unit tests: model-less abstraction, profiler, Algorithm-1 selection,


@pytest.fixture()
def store():
    s = MetadataStore()
    prof.register_all(s.registry, [ARCHS["llama3.2-1b"], ARCHS["yi-9b"],
                                   ARCHS["whisper-base"]])
    # one live accel worker, one cpu worker
    s.upsert_worker("w0", ("cpu-host", "h100-1"), 0.0)
    s.heartbeat("w0", {"cpu-host": 0.1, "h100-1": 0.2},
                {"cpu-host": 0.0, "h100-1": 0.0}, 0.0)
    s.upsert_worker("w1", ("cpu-host",), 0.0)
    s.heartbeat("w1", {"cpu-host": 0.05}, {"cpu-host": 0.0}, 0.0)
    return s


def test_variant_generation_counts():
    reg = Registry()
    n = prof.register_all(reg, list(ARCHS.values()))
    assert n >= 80, f"variant zoo too small: {n}"
    # every variant fits its platform
    for v in reg.variants.values():
        assert v.profile.peak_memory <= HW.HARDWARE[v.hardware].mem_capacity
    # the giants have no host-feasible cpu f32 variant
    big = [v for v in reg.variants.values()
           if v.arch == "qwen3-moe-235b-a22b" and v.hardware == "cpu-host"]
    assert not big


def test_linear_fit_matches_roofline():
    cfg = ARCHS["llama3.2-1b"]
    hw = HW.HARDWARE["h100-1"]
    p = prof.analytic_profile(cfg, hw, "bf16", 8)
    wl = prof.workload_model(cfg)
    for b in (1, 4, 8):
        t_roof = HW.roofline_latency(
            wl.flops(b), wl.bytes_moved(b, wl.n_total * 2.0), hw, 0.6)
        assert p.latency(b) == pytest.approx(t_roof, rel=0.35), b


def test_int8_variant_faster_at_small_batch():
    cfg = ARCHS["llama3.2-1b"]
    hw = HW.HARDWARE["h100-1"]
    p8 = prof.analytic_profile(cfg, hw, "int8", 1)
    p16 = prof.analytic_profile(cfg, hw, "bf16", 1)
    assert p8.latency(1) < p16.latency(1)


def test_selection_outcome3_load(store):
    sel = VariantSelector(store)
    r = sel.select_arch("llama3.2-1b", 1, 0.05)
    assert r.outcome == "load" and r.variant is not None
    assert r.worker in ("w0", "w1")
    # the chosen variant minimizes load+inference among valid ones
    v = r.variant
    for w in store.registry.variants_of("llama3.2-1b"):
        if w.profile.max_batch >= 1 and w.profile.latency(1) <= 0.05 \
                and sel._worker_for_load(w) is not None:
            assert (v.profile.load_latency + v.profile.latency(1)) <= \
                (w.profile.load_latency + w.profile.latency(1)) + 1e-9


def test_selection_prefers_running_then_caches(store):
    sel = VariantSelector(store)
    # mark one valid variant as running on w0
    cands = [v for v in store.registry.variants_of("llama3.2-1b")
             if v.hardware == "h100-1"]
    v = cands[0]
    store.set_instance(InstanceState(variant=v.name, worker="w0",
                                     running=True))
    r1 = sel.select_arch("llama3.2-1b", 1, 1.0)
    assert r1.outcome == "running" and r1.variant.name == v.name
    r2 = sel.select_arch("llama3.2-1b", 1, 1.0)
    assert r2.outcome == "cache" and r2.variant.name == v.name
    # overload the instance -> cache must not return it
    inst = store.instance(v.name, "w0")
    inst.qps = 1e9
    r3 = sel.select_arch("llama3.2-1b", 1, 1.0)
    assert r3.outcome != "cache" or r3.variant.name != v.name


def test_usecase_selection_respects_accuracy(store):
    sel = VariantSelector(store)
    r = sel.select_usecase("text-generation", "openwebtext",
                           accuracy=0.71, batch=1, latency_slo=None)
    assert r.variant is not None
    assert r.variant.arch == "yi-9b"    # only arch above 0.71 registered here
    r2 = sel.select_usecase("asr", "librispeech", 0.0, 1, None)
    assert r2.variant.arch == "whisper-base"
    r3 = sel.select_usecase("text-generation", "openwebtext",
                            accuracy=0.99, batch=1, latency_slo=None)
    assert r3.outcome == "reject"


def test_variant_validity_batch_and_slo(store):
    sel = VariantSelector(store)
    r = sel.select_arch("llama3.2-1b", 64, None)
    assert r.variant.profile.max_batch >= 64


def test_snapshot_restore_roundtrip(store):
    blob = store.snapshot()
    restored = MetadataStore.restore(blob)
    assert set(restored.registry.archs) == set(store.registry.archs)
    assert set(restored.registry.variants) == set(store.registry.variants)
    v0 = next(iter(store.registry.variants.values()))
    v1 = restored.registry.variants[v0.name]
    assert v1.profile.m == pytest.approx(v0.profile.m)
    # dynamic state intentionally NOT in the snapshot
    assert not restored.workers


def test_private_model_access(store):
    from repro_torch.core.abstraction import ModelArchInfo
    store.registry.add_arch(ModelArchInfo(
        name="secret", task="text-generation", dataset="openwebtext",
        accuracy=0.99, submitter="alice", is_private=True,
        allowed_users=("bob",)))
    reg = store.registry
    assert reg.archs["secret"].accessible_by("alice")
    assert reg.archs["secret"].accessible_by("bob")
    assert not reg.archs["secret"].accessible_by("eve")

# ======================================================================
# mirrors tests/test_serving_sim.py
# Integration tests: master + workers + two-level autoscaler + offline


def test_online_query_lifecycle():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    q = c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000)
    c.run_until(60.0)
    assert _done(q), (q.failed, q.finish)
    v = c.store.registry.variants[q.variant]
    # cold query: latency ~ load + inference (+ dispatch slack)
    expected = v.profile.load_latency + v.profile.latency(1)
    assert q.latency == pytest.approx(expected, rel=0.5)
    # decision overhead was recorded
    assert c.master.decision_log and c.master.decision_log[0][0] == "modarch"


def test_warm_queries_are_fast_and_cached():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000)
    # stay inside the T_accel=20s scale-down hysteresis so the loaded
    # variant is still resident (beyond it, the worker autoscaler correctly
    # downgrades the idle variant and invalidates the cache)
    c.run_until(8.0)
    q2 = c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000)
    c.run_until(10.0)
    assert _done(q2)
    v = c.store.registry.variants[q2.variant]
    assert q2.latency < 0.1 + v.profile.latency(1) * 3
    assert c.master.decision_log[-1][0] == "modarch"
    # second identical query must come from the decision cache
    sel = c.master.selector.select_arch(LLAMA.name, 1, 5.0)
    assert sel.outcome == "cache"


def test_idle_accel_variant_downgrades_over_time():
    """Zero load: the worker autoscaler walks the variant down the batch
    ladder (b16 -> ... -> b1 -> CPU eventually), T_accel ticks per rung."""
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    q = c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000)
    c.run_until(220.0)
    assert _done(q)
    w = next(iter(c.master.workers.values()))
    # after repeated hysteresis windows with zero load, nothing should be
    # left occupying the accelerator
    accel_left = [li.variant.name for li in w.instances.values()
                  if li.variant.is_accel]
    assert not accel_left, accel_left


def test_adaptive_batching_under_burst():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    v = [x for x in c.store.registry.variants.values()
         if x.hardware == "h100-1" and x.batch_opt == 8
         and "bf16" in x.framework][0]
    w = next(iter(c.master.workers.values()))
    w.load_variant(v)
    c.run_until(10.0)
    qs = [c.api.online_query(mod_var=v.name, latency_ms=5000)
          for _ in range(64)]
    c.run_until(20.0)
    assert all(_done(q) for q in qs)
    serial = 64 * v.profile.latency(1)
    makespan = max(q.finish for q in qs) - min(q.arrival for q in qs)
    # adaptive batching packs 8 requests/job: ~8 jobs of t(8) << 64 x t(1)
    assert makespan < serial * 0.6, (makespan, serial)


def test_worker_autoscaler_replicates_on_cpu():
    c = make_cluster(n_accel=0, n_cpu=1, archs=[LLAMA], autoscale=False)
    cpu_variants = [v for v in c.store.registry.variants.values()
                    if v.hardware == "cpu-host"]
    v = max(cpu_variants, key=lambda x: x.profile.peak_qps)
    w = next(iter(c.master.workers.values()))
    w.load_variant(v)
    c.run_until(10.0)
    rate = v.profile.peak_qps * 1.6   # beyond one replica
    poisson_arrivals(
        c.loop, lambda t: rate,
        lambda t: c.api.online_query(mod_var=v.name, latency_ms=10_000),
        t_end=40.0, seed=1)
    c.run_until(30.0)   # mid-load: replicas grew
    li = w.instances.get(v.name)
    assert li is not None and li.replicas >= 2, li.replicas
    c.run_until(120.0)  # load gone: hysteretic scale-down kicks in
    li = w.instances.get(v.name)
    assert li is None or li.replicas < 4


def test_worker_autoscaler_upgrades_accel_variant():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    accel_b1 = [v for v in c.store.registry.variants.values()
                if v.hardware == "h100-1" and v.batch_opt == 1
                and "bf16" in v.framework][0]
    w = next(iter(c.master.workers.values()))
    w.load_variant(accel_b1)
    c.run_until(10.0)
    rate = accel_b1.profile.peak_qps * 2.5
    poisson_arrivals(
        c.loop, lambda t: rate,
        lambda t: c.api.online_query(mod_arch=LLAMA.name, latency_ms=10_000),
        t_end=60.0, seed=2)
    c.run_until(90.0)
    batches = [li.variant.batch_opt for li in w.instances.values()
               if li.variant.is_accel]
    assert batches and max(batches) > 1, batches


def test_scale_down_is_hysteretic():
    c = make_cluster(n_accel=0, n_cpu=1, archs=[LLAMA], autoscale=False)
    v = max((x for x in c.store.registry.variants.values()
             if x.hardware == "cpu-host"), key=lambda x: x.profile.peak_qps)
    w = next(iter(c.master.workers.values()))
    w.load_variant(v, replicas=3)
    c.run_until(5.0)
    li = w.instances[v.name]
    assert li.replicas == 3
    # zero load: must NOT scale down before T_cpu=10 autoscale ticks
    c.run_until(5.0 + 5.0)
    assert w.instances[v.name].replicas == 3
    c.run_until(5.0 + 30.0)
    assert w.instances[v.name].replicas < 3


def test_offline_best_effort_and_throttling():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    job = c.api.offline_query(mod_arch=LLAMA.name, n_inputs=2000)
    c.run_until(120.0)
    assert job.processed > 0, "offline job made no progress in slack"
    # online queries co-located with offline still meet relaxed SLOs
    qs = [c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000)
          for _ in range(16)]
    c.run_until(240.0)
    assert all(_done(q) for q in qs)
    online_viol = sum(q.violated for q in qs)
    assert online_viol <= 2, online_viol


def test_worker_failure_redispatch():
    cfg = MasterConfig()
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False, cfg=cfg)
    c.api.online_query(mod_arch=LLAMA.name, latency_ms=10_000)
    c.run_until(30.0)
    # saturate both workers then kill one
    qs = [c.api.online_query(mod_arch=LLAMA.name, latency_ms=60_000)
          for _ in range(32)]
    victims = [n for n, w in c.master.workers.items()
               if any(li.pending or li.outstanding
                      for li in w.instances.values())]
    assert victims
    c.master.fail_worker(victims[0])
    c.run_until(240.0)
    done = [q for q in qs if _done(q)]
    assert len(done) == len(qs), f"{len(done)}/{len(qs)} after failure"
    # dead worker is out of the routing tables
    assert not c.store.workers[victims[0]].alive


def test_hedged_requests_cut_straggler_latency():
    """The reference's version of this test never hedges (its worker
    autoscaler unloads the fast worker's idle copy before the query) and
    passes by float rounding. Here both copies stay loaded, the straggler
    (added first) takes the query, and the hedge must win by a wide
    margin."""
    cfg = MasterConfig(hedge_enabled=True, hedge_factor=2.0,
                       worker_autoscale=False)
    c = make_cluster(n_accel=0, archs=[LLAMA], autoscale=False, cfg=cfg)
    c.master.add_worker("accel", name="straggler", slowdown=25.0)
    c.master.add_worker("accel", name="fast")
    # preload the same variant on both workers
    v = [x for x in c.store.registry.variants.values()
         if x.hardware == "h100-1" and x.batch_opt == 8
         and "bf16" in x.framework][0]
    for w in c.master.workers.values():
        w.load_variant(v)
    c.run_until(60.0)
    # route a query to the straggler explicitly
    q = c.master.online_query(n_inputs=1, slo=30.0, variant=v.name)
    c.run_until(300.0)
    assert _done(q)
    slow_latency = v.profile.latency(1) * 25.0
    assert q.worker == "fast"
    assert q.latency < slow_latency / 2, (q.latency, slow_latency)


def test_master_autoscaler_adds_and_removes_workers():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=True)
    v = [x for x in c.store.registry.variants.values()
         if x.hardware == "h100-1" and x.batch_opt == 8
         and "bf16" in x.framework][0]
    rate = v.profile.peak_qps * 1.5
    poisson_arrivals(
        c.loop, lambda t: rate,
        lambda t: c.api.online_query(mod_arch=LLAMA.name, latency_ms=2000),
        t_end=45.0, seed=3)
    c.run_until(60.0)
    n_peak = sum(1 for w in c.store.workers.values() if w.alive)
    assert n_peak > 1, "master autoscaler never scaled out"
    # cool-down: idle variants unload, then idle workers retire
    c.run_until(300.0)
    n_end = sum(1 for w in c.store.workers.values() if w.alive)
    assert n_end < n_peak


def test_metadata_heartbeat_failure_detection():
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False)
    c.run_until(10.0)
    name = next(iter(c.master.workers))
    # silence heartbeats without the master's fail_worker shortcut
    c.master.workers[name].alive = False
    c.run_until(30.0)
    assert not c.store.workers[name].alive, \
        "missed heartbeats did not mark the worker dead"

# ======================================================================
# mirrors tests/test_master_faults.py
# Fault-injection hardening for the control plane.


def test_hung_worker_queries_redispatch_and_complete():
    """Regression: a heartbeat-silent (hung, not failed) worker's pending
    and in-flight queries used to strand forever — the sweep marked the
    worker dead in the store but never failed its queries, and a hung
    worker's scheduled completions never fire. They must re-dispatch and
    complete."""
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False)
    c.api.online_query(mod_arch=LLAMA.name, latency_ms=10_000)
    c.run_until(30.0)
    qs = [c.api.online_query(mod_arch=LLAMA.name, latency_ms=60_000)
          for _ in range(32)]
    victims = [n for n, w in c.master.workers.items()
               if any(li.pending or li.outstanding
                      for li in w.instances.values())]
    assert victims
    c.master.workers[victims[0]].hang()      # silent: no fail_worker call
    c.run_until(240.0)
    done = [q for q in qs if _done(q)]
    assert len(done) == len(qs), \
        f"{len(done)}/{len(qs)} completed after silent hang"
    assert not c.store.workers[victims[0]].alive, \
        "heartbeat sweep never detected the hung worker"
    # the stranded queries went around the retry loop at least once
    assert max(q.attempts for q in qs) > 1
    assert all(q.attempts >= 1 for q in qs)


def test_transient_failure_recovers_with_attempt_count():
    """An explicit worker failure is transient cluster-wide: the other
    worker absorbs the re-dispatches, and the retried queries carry
    attempts > 1 all the way into the public QueryResult."""
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False)
    c.api.online_query(mod_arch=LLAMA.name, latency_ms=10_000)
    c.run_until(30.0)
    hs = [c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=60_000))
          for _ in range(16)]
    victims = [n for n, w in c.master.workers.items()
               if any(li.pending or li.outstanding
                      for li in w.instances.values())]
    assert victims
    c.master.fail_worker(victims[0])
    c.run_until(240.0)
    results = [h.result(timeout=1.0) for h in hs]
    assert all(r.ok for r in results)
    assert max(r.attempts for r in results) > 1
    assert all(r.attempts >= 1 for r in results)


def test_permanent_failure_exhausts_backoff_budget():
    """With every worker dead, a query burns its full retry budget —
    max_retries + 1 attempts — spread over at least the deterministic
    part of the exponential backoff schedule, then fails for good."""
    cfg = MasterConfig()
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False, cfg=cfg)
    c.run_until(10.0)
    for name in list(c.master.workers):
        c.master.fail_worker(name)
    t0 = c.loop.now()
    q = c.api.online_query(mod_arch=LLAMA.name, latency_ms=5000)
    c.run_until(t0 + 120.0)
    assert q.failed
    assert q.attempts == cfg.max_retries + 1
    # sum of min(delay * backoff**k, cap) for k = 0..max_retries-1,
    # jitter can shave at most retry_jitter off each wait
    sched = sum(min(cfg.retry_delay * cfg.retry_backoff ** k,
                    cfg.retry_delay_cap) for k in range(cfg.max_retries))
    assert q.finish - t0 >= sched * (1.0 - cfg.retry_jitter), \
        (q.finish - t0, sched)
    assert q.finish - t0 <= sched * (1.0 + cfg.retry_jitter) + 1.0


def test_backoff_delays_grow_and_cap():
    """The per-retry delay schedule is exponential, capped, and jittered
    within +/- retry_jitter."""
    cfg = MasterConfig(retry_delay=0.1, retry_backoff=2.0,
                       retry_delay_cap=0.5, retry_jitter=0.1)
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False, cfg=cfg)
    m = c.master
    for k, base in enumerate([0.1, 0.2, 0.4, 0.5, 0.5, 0.5]):
        for _ in range(3):
            d = m._retry_delay_for(k)
            assert base * 0.9 <= d <= base * 1.1, (k, d, base)
    # jitter desynchronizes retries: not every draw is identical
    draws = {round(m._retry_delay_for(3), 6) for _ in range(16)}
    assert len(draws) > 1


def test_hung_worker_offline_job_not_stranded():
    """Offline jobs on a hung worker fail through the abandon path and
    re-enter the master's offline retry loop once the sweep fires."""
    c = make_cluster(n_accel=2, archs=[LLAMA], autoscale=False)
    c.run_until(10.0)
    h = c.api.submit(QuerySpec.arch(LLAMA.name, mode="offline",
                                    n_inputs=64))
    c.run_until(12.0)
    hosts = [n for n, w in c.master.workers.items() if w.offline_jobs]
    if hosts:                       # job already placed: hang its host
        c.master.workers[hosts[0]].hang()
    c.run_until(400.0)
    r = h.result(timeout=1.0)
    assert r.ok, "offline job stranded on hung worker"
    assert r.attempts >= 1

# ======================================================================
# mirrors tests/test_clock.py
# Clock abstraction symmetry: both clocks implement the full scheduling surface.


def test_both_clocks_expose_the_same_surface():
    for loop in (EventLoop(), RealClock()):
        for name in ("now", "schedule", "schedule_at", "every",
                     "next_event_time", "run_until", "shutdown"):
            assert callable(getattr(loop, name, None)), \
                f"{type(loop).__name__} missing {name}"
        if isinstance(loop, RealClock):
            loop.shutdown()
    assert EventLoop.virtual is True
    assert RealClock.virtual is False
    assert Clock.virtual is True      # default matches the sim path


def test_eventloop_every_applies_jitter_to_every_interval():
    """jitter is a per-task phase offset on *each* firing, not just the
    first: two tasks with equal period but different jitter must never
    collapse onto the same firing times."""
    loop = EventLoop()
    a, b = [], []
    loop.every(10.0, lambda: a.append(loop.now()), jitter=1.0)
    loop.every(10.0, lambda: b.append(loop.now()), jitter=3.0)
    loop.run_until(70.0)
    assert a == [11.0, 22.0, 33.0, 44.0, 55.0, 66.0]
    assert b == [13.0, 26.0, 39.0, 52.0, 65.0]
    assert not set(a) & set(b)


def test_eventloop_every_stop_predicate():
    loop = EventLoop()
    fired = []
    loop.every(5.0, lambda: fired.append(loop.now()),
               stop=lambda: loop.now() > 12.0)
    loop.run_until(100.0)
    assert fired == [5.0, 10.0]


def test_realclock_schedule_fires_in_deadline_order():
    loop = RealClock()
    try:
        fired = []
        done = threading.Event()
        loop.schedule(0.10, lambda: (fired.append("late"), done.set()))
        loop.schedule(0.01, lambda: fired.append("early"))
        loop.schedule(0.05, lambda: fired.append("mid"))
        assert done.wait(5.0)
        assert fired == ["early", "mid", "late"]
    finally:
        loop.shutdown()


def test_realclock_now_and_next_event_time():
    loop = RealClock()
    try:
        t = loop.now()
        assert t >= 0.0
        assert loop.next_event_time() is None
        loop.schedule_at(t + 60.0, lambda: None)
        nxt = loop.next_event_time()
        assert nxt is not None and nxt >= t + 59.0
        assert loop.pending() == 1
    finally:
        loop.shutdown()


def test_realclock_callbacks_may_schedule_more_work():
    """every() chains tick -> schedule -> tick on the scheduler thread;
    the lock must be released during callbacks for this to make progress."""
    loop = RealClock()
    try:
        fired = []
        enough = threading.Event()

        def tick():
            fired.append(loop.now())
            if len(fired) >= 3:
                enough.set()

        loop.every(0.01, tick, stop=enough.is_set)
        assert enough.wait(5.0)
        assert len(fired) >= 3
        assert fired == sorted(fired)
    finally:
        loop.shutdown()


def test_realclock_survives_raising_callback():
    loop = RealClock()
    try:
        ok = threading.Event()
        loop.schedule(0.0, lambda: 1 / 0)
        loop.schedule(0.02, ok.set)
        assert ok.wait(5.0), "scheduler died after a raising callback"
    finally:
        loop.shutdown()


def test_realclock_shutdown_drops_pending_and_rejects_new_work():
    loop = RealClock()
    fired = []
    loop.schedule(30.0, lambda: fired.append("too late"))
    loop.shutdown()
    assert loop.pending() == 0
    loop.schedule(0.0, lambda: fired.append("after stop"))   # no-op
    time.sleep(0.05)
    assert fired == []


def test_realclock_shutdown_is_idempotent():
    """Fault-recovery paths (executor restart, runtime teardown, test
    finalizers) may race to shut the same clock down; the second and
    later calls must be clean no-ops."""
    loop = RealClock()
    loop.schedule(30.0, lambda: None)
    loop.shutdown()
    loop.shutdown()
    loop.shutdown()
    assert loop.pending() == 0


def test_realclock_shutdown_from_callback_does_not_deadlock():
    """A callback that triggers shutdown (e.g. a failure handler tearing
    the runtime down from the scheduler thread) must not deadlock the
    scheduler joining itself."""
    loop = RealClock()
    done = threading.Event()

    def suicidal():
        loop.shutdown()
        done.set()

    loop.schedule(0.01, suicidal)
    assert done.wait(5.0), "shutdown() from a callback wedged the clock"
    loop.shutdown()                  # still idempotent afterwards
    assert loop.pending() == 0


def test_realclock_run_until_blocks_while_events_fire():
    loop = RealClock()
    try:
        fired = []
        loop.schedule(0.03, lambda: fired.append(loop.now()))
        t0 = loop.now()
        loop.run_until(t0 + 0.08)
        assert loop.now() >= t0 + 0.08
        assert len(fired) == 1
    finally:
        loop.shutdown()

# ======================================================================
# mirrors tests/test_system.py
# End-to-end behaviour test for the full INFaaS system: register models,


def test_full_system_lifecycle():
    c = make_cluster(n_accel=2, n_cpu=1,
                     archs=[ARCHS["llama3.2-1b"], ARCHS["yi-9b"],
                            ARCHS["whisper-base"]], autoscale=True)

    # all three granularities of the model-less abstraction
    qs = [
        c.api.online_query(mod_arch="llama3.2-1b", latency_ms=200),
        c.api.online_query(task="text-generation", dataset="openwebtext",
                           accuracy=0.71, latency_ms=500),
        c.api.online_query(task="asr", dataset="librispeech",
                           accuracy=0.0, latency_ms=500),
    ]
    # background load + an offline job sharing the same workers
    poisson_arrivals(
        c.loop, lambda t: 30.0,
        lambda t: c.api.online_query(mod_arch="llama3.2-1b", latency_ms=200),
        t_end=40.0, seed=0)
    job = c.api.offline_query(mod_arch="yi-9b", n_inputs=100)

    c.run_until(20.0)
    # inject a worker failure mid-run
    victim = next(iter(c.master.workers))
    c.master.fail_worker(victim)
    c.run_until(120.0)

    # the three tagged queries completed on suitable variants
    assert all(q.finish >= 0 and not q.failed for q in qs)
    assert qs[1].variant.startswith("yi-9b")          # accuracy bound
    assert qs[2].variant.startswith("whisper-base")   # task routing
    # background load survived the failure (re-dispatch)
    done = [q for q in c.master.metrics if q.kind == "online"]
    ok = [q for q in done if not q.failed]
    assert len(ok) / max(len(done), 1) > 0.95, \
        f"only {len(ok)}/{len(done)} queries survived the failure"
    # offline made progress in the slack
    assert job.processed > 0
    # dead worker is fully evicted from the routing state
    assert not c.store.workers[victim].alive
    assert not c.store.worker_instances(victim)

    # metadata snapshot -> restore preserves the registry (master failover)
    blob = c.store.snapshot()
    restored = MetadataStore.restore(blob)
    assert set(restored.registry.variants) == set(c.store.registry.variants)

# ======================================================================
# mirrors tests/test_property_system.py
# Property-based tests (hypothesis) on control-plane invariants.


@given(st.lists(st.floats(0, 100), min_size=1, max_size=50),
       st.integers(0, 2**31 - 1))
def test_eventloop_fires_in_time_order(delays, seed):
    loop = EventLoop()
    fired = []
    for i, d in enumerate(delays):
        loop.schedule(d, (lambda ii, dd: lambda: fired.append((loop.now())))(
            i, d))
    loop.run_until(1e9)
    assert fired == sorted(fired)
    assert len(fired) == len(delays)


@given(st.floats(1e-6, 10), st.floats(0, 10))
def test_fit_linear_recovers_exact_line(m, c):
    batches = [1, 4, 8]
    lats = [m * b + c for b in batches]
    m2, c2 = prof.fit_linear(batches, lats)
    np.testing.assert_allclose([m2, c2], [max(m, 1e-9), max(c, 1e-6)],
                               rtol=1e-6, atol=1e-6)


@given(st.integers(2, 40), st.floats(0.5, 2.0))
def test_zipf_weights_normalized_and_monotone(n, alpha):
    w = zipf_weights(n, alpha)
    assert abs(w.sum() - 1.0) < 1e-9
    assert all(w[i] >= w[i + 1] for i in range(n - 1))


@given(st.integers(2, 10))
def test_popularity_split_80_20(n):
    archs = [f"arch{i}" for i in range(n)]
    split = popularity_split(archs)
    total = sum(split.weights.values())
    assert abs(total - 1.0) < 1e-9
    pop_mass = sum(split.weights[a] for a in split.popular)
    if split.cold:
        assert abs(pop_mass - 0.8) < 1e-9


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 64), st.one_of(st.none(), st.floats(1e-3, 10.0)))
def test_selection_respects_batch_and_slo(batch, slo):
    store = MetadataStore()
    prof.register_all(store.registry, [ARCHS["llama3.2-1b"]])
    store.upsert_worker("w0", ("cpu-host", "h100-1"), 0.0)
    store.heartbeat("w0", {"cpu-host": 0.1, "h100-1": 0.1},
                    {"cpu-host": 0.0, "h100-1": 0.0}, 0.0)
    sel = VariantSelector(store)
    r = sel.select_arch("llama3.2-1b", batch, slo)
    if r.variant is not None and r.reason != "slo-relaxed":
        assert batch <= r.variant.profile.max_batch
        if slo is not None:
            assert r.variant.profile.latency(batch) <= slo + 1e-9


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(20.0, 300.0))
def test_sim_invariants_under_random_load(seed, rate):
    """Random Poisson load: memory accounting, replica caps, and query
    timestamps stay consistent throughout."""
    c = make_cluster(n_accel=1, n_cpu=1, archs=[ARCHS["llama3.2-1b"]],
                     autoscale=False)
    poisson_arrivals(
        c.loop, lambda t: rate,
        lambda t: c.api.online_query(mod_arch="llama3.2-1b",
                                     latency_ms=5000),
        t_end=20.0, seed=seed)
    c.run_until(40.0)
    for w in c.master.workers.values():
        for hname, dev in w.devices.items():
            assert dev.mem_used <= dev.hw.mem_capacity + 1e-6
            assert dev.active >= 0
        cpu = w.devices.get("cpu-host")
        if cpu is not None:
            used = sum(li.replicas for li in w.instances.values()
                       if not li.variant.is_accel)
            assert used <= cpu.slots
    for q in c.master.metrics:
        if q.finish >= 0 and not q.failed:
            assert q.arrival <= q.start <= q.finish
            v = c.store.registry.variants[q.variant]
            assert q.n_inputs <= v.profile.max_batch


# ======================================================================
# sim parity against the reference: a CPU-only cluster, where the catalogs
# agree field for field, must give the same trace to the last bit


def _sim_trace(core, fault_cls, seed=7):
    """Serve one seeded stream of cpu-host variant queries and arch queries
    through the sim backend of one package (``core`` holds its modules),
    with a worker hang injected and the circuit breaker on; return every
    observable of the run."""
    cfg = core["MasterConfig"](
        worker_autoscale=False, breaker_enabled=True,
        worker=core["WorkerConfig"](faults=fault_cls(
            seed=seed, schedule={"worker_hang": [9]})))
    c = core["make_cluster"](backend="sim", n_accel=0, n_cpu=2,
                             archs=[core["ARCHS"]["llama3.2-1b"]],
                             autoscale=False, cfg=cfg)
    QS = core["QuerySpec"]
    names = sorted(v.name for v in c.store.registry.variants.values()
                   if v.hardware == "cpu-host")
    rng = np.random.default_rng(seed)
    handles = []

    def fire(t):
        k = int(rng.integers(0, len(names) + 1))
        n = int(rng.integers(1, 5))
        slo = float(rng.choice([0.05, 0.5, 5.0]))
        spec = (QS.arch("llama3.2-1b", slo=slo, n_inputs=n)
                if k == len(names) else QS.variant(names[k], slo=slo,
                                                   n_inputs=n))
        handles.append(c.api.submit(spec))

    core["poisson_arrivals"](c.loop, lambda t: 6.0, fire, t_end=40.0,
                             seed=seed)
    c.run_until(120.0)
    out = []
    for h in handles:
        r = h.result(timeout=0.0)
        out.append((r.variant, r.worker, r.ok, r.failed, r.latency,
                    r.queue, r.load, r.compute, r.slo_met, r.attempts))
    cpu = [(v.name, v.batch_opt, v.accuracy, v.profile.m, v.profile.c,
            v.profile.load_latency, v.profile.peak_memory,
            v.profile.max_batch, v.profile.peak_qps)
           for v in c.store.registry.variants.values()
           if v.hardware == "cpu-host"]
    return out, list(c.master.breaker_events), sorted(cpu)


def _core_of(pkg):
    import importlib
    mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
        "configs.registry", "core.api", "core.master", "core.worker",
        "sim.cluster", "sim.workload", "serving.faults")}
    core = {"ARCHS": mods["configs.registry"].ARCHS,
            "QuerySpec": mods["core.api"].QuerySpec,
            "MasterConfig": mods["core.master"].MasterConfig,
            "WorkerConfig": mods["core.worker"].WorkerConfig,
            "make_cluster": mods["sim.cluster"].make_cluster,
            "poisson_arrivals": mods["sim.workload"].poisson_arrivals}
    return core, mods["serving.faults"].FaultInjector


def test_sim_trace_identical_to_reference_on_cpu_cluster():
    """Exact equality, no tolerance: the cpu-host catalog entries, the
    profiles derived from them and the control-plane code are the same, so
    every float of the trace — completion times, latencies and their
    breakdown — must be the same bits. The stream carries retries (a
    hung worker's queries) and SLO misses; the breaker log must agree
    too."""
    ref_core, ref_faults = _core_of("repro")
    port_core, port_faults = _core_of("repro_torch")
    ref = _sim_trace(ref_core, ref_faults)
    port = _sim_trace(port_core, port_faults)
    queries, breakers, cpu_variants = port
    assert cpu_variants == ref[2] and len(cpu_variants) == 3
    assert breakers == ref[1]
    assert len(queries) == len(ref[0]) > 100
    for i, (a, b) in enumerate(zip(queries, ref[0])):
        assert a == b, (i, a, b)
    # the stream exercised what it claims to: retries, misses, both kinds
    assert any(q[9] > 1 for q in queries)
    assert any(q[8] is False for q in queries)
    assert any(q[8] is True for q in queries)
    assert breakers
    assert all(q[0].split("/")[1] == "cpu-host" for q in queries if q[2])


# ======================================================================
# what the port changes: the H100 catalog, its labels and the registry


def test_h100_catalog_from_the_data_sheet():
    from repro.sim import hardware as J_HW
    assert set(HW.HARDWARE) == {"cpu-host", "h100-1", "h100-4"}
    # the host entry is the reference's, field for field
    assert dataclasses.astuple(HW.HARDWARE["cpu-host"]) == \
        dataclasses.astuple(J_HW.HARDWARE["cpu-host"])
    one, four = HW.HARDWARE["h100-1"], HW.HARDWARE["h100-4"]
    assert (one.kind, one.chips, four.kind, four.chips) == \
        ("accel", 1, "accel", 4)
    assert one.peak_flops == 989e12 and one.mem_bw == 3.35e12
    assert one.mem_capacity == 80e9 and one.load_bw == 64e9
    assert HW.H100_NVLINK_BW == 900e9
    for f in ("peak_flops", "mem_bw", "mem_capacity", "load_bw",
              "cost_rate"):
        assert getattr(four, f) == 4 * getattr(one, f), f
    # price ratio and provisioning model: the reference's units
    assert one.cost_rate / HW.HARDWARE["cpu-host"].cost_rate >= 6.0
    assert (one.startup_latency, four.startup_latency) == (15.0, 20.0)
    # no TPU constant or label survives in the port's catalog
    assert not [n for n in dir(HW) if "V5E" in n or "ICI" in n]


def test_accel_workers_get_h100_1():
    c = make_cluster(n_accel=1, n_cpu=1, archs=[LLAMA], autoscale=False)
    hw = {n: tuple(w.devices) for n, w in c.master.workers.items()}
    assert hw == {"worker-accel-0": ("cpu-host", "h100-1"),
                  "worker-cpu-1": ("cpu-host",)}
    assert c.store.workers["worker-accel-0"].hardware == \
        ("cpu-host", "h100-1")


def test_master_autoscaler_boots_h100_workers_after_startup_latency():
    c = make_cluster(n_accel=0, archs=[LLAMA], autoscale=False)
    booted = []
    c.master._start_worker_async("accel", lambda: booted.append(
        c.loop.now()))
    c.run_until(60.0)
    assert booted == [HW.HARDWARE["h100-1"].startup_latency]
    (w,) = c.master.workers.values()
    assert tuple(w.devices) == ("cpu-host", "h100-1")


def test_serving_archs_are_the_registry_minus_the_multi_card_giant():
    from repro_torch.sim.cluster import serving_archs
    names = [a.name for a in serving_archs()]
    # llama-3.2-vision-90b's 175 GB of bf16 weights fit no single card or
    # host slot; every other registered arch has an h100-1 variant
    assert names == [n for n in ARCHS if n != "llama-3.2-vision-90b"]
    for cfg in serving_archs():
        assert any(v.hardware == "h100-1"
                   for v in prof.generate_variants(cfg)), cfg.name


def test_variants_carry_torch_frameworks_on_the_h100_catalog():
    vs = prof.generate_variants(LLAMA)
    assert {v.hardware for v in vs} == {"cpu-host", "h100-1", "h100-4"}
    assert {v.framework for v in vs} == {"torch-f32", "torch-bf16",
                                         "torch-int8"}
    for v in vs:
        assert v.framework == "torch-" + v.name.rsplit("/", 1)[1].split(
            "-")[0]


def test_analytic_profiles_match_the_reference_formula_on_the_h100():
    """The profiler is the reference's; only the catalog differs, so
    feeding the reference's profiler the port's H100 spec gives the same
    numbers."""
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro.core import profiler as J_prof
    for name in ("llama3.2-1b", "yi-9b", "phi3-mini-3.8b", "minitron-8b"):
        assert ARCHS[name].active_param_count() == \
            J_ARCHS[name].active_param_count()
        for dtype, b in (("bf16", 8), ("int8", 1), ("bf16", 64)):
            mine = prof.analytic_profile(ARCHS[name],
                                         HW.HARDWARE["h100-1"], dtype, b)
            ref = J_prof.analytic_profile(J_ARCHS[name],
                                          HW.HARDWARE["h100-1"], dtype, b)
            assert dataclasses.astuple(mine) == dataclasses.astuple(ref)


def test_dense_configs_copied_field_for_field():
    from repro.configs.registry import ARCHS as J_ARCHS
    for name in ("minitron-8b", "yi-9b", "phi3-mini-3.8b"):
        mine, ref = ARCHS[name], J_ARCHS[name]
        for f in dataclasses.fields(mine):
            if f.name not in ("attention_impl", "quantize"):
                assert getattr(mine, f.name) == getattr(ref, f.name), \
                    (name, f.name)
        assert mine.param_count() == ref.param_count()


def test_phi3_mini_cuda_build_raises_naming_head_dim_96():
    from repro_torch.models import build_model
    cfg = ARCHS["phi3-mini-3.8b"]
    with pytest.raises(ValueError, match="head_dim 96"):
        build_model(cfg.for_device("cuda"), device="cuda")
    # the plain impls take it on the CPU (reduced width)
    build_model(dataclasses.replace(cfg, head_dim=96, d_model=192,
                                    n_heads=2, n_kv_heads=2, n_layers=1,
                                    d_ff=64, vocab=64, dtype="float32",
                                    param_dtype="float32"), device="cpu")


def test_wall_clock_cluster_is_not_ported():
    with pytest.raises(NotImplementedError, match="clock='wall'"):
        make_cluster(n_accel=0, archs=[LLAMA], backend="real",
                     clock="wall", device="cpu", reduced=True)


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port and ``chip_smoke.py``, read with ``ast``:
    no import of ``jax`` or of the reference package, at any depth."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 40
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
