"""The port's real data plane behind the control plane
(``repro_torch.serving.executor.EngineExecutor``) on the CPU.

* Mirrors of the reference's executor tests: a payload-carrying
  ``QuerySpec`` goes master -> selection -> worker -> ``EngineExecutor`` ->
  ``ServingEngine`` and its tokens come back through
  ``QueryHandle.result()``; synthetic runs re-fit the variant profiles.
  The clusters are ``make_cluster(backend="real", device="cpu",
  reduced=True)``. The direct-engine oracle runs on the params the served
  variant's engine holds (the int8 tree for a ``torch-int8`` variant).
* Real-backend parity: the JAX cluster and the port's take the same
  ``VariantTarget`` payload queries, the port's executor serving the JAX
  executor's own weights (fp and int8 trees, carried by
  ``convert.params_from_jax``); the tokens must be equal.
* The admission knobs and the query's SLO reach the engines, streamed
  chunks reach the query; the executor knobs this slice lacks raise by
  name, and a real cluster asks for CUDA unless told otherwise.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs.registry import ARCHS
from repro_torch.core import profiler as prof
from repro_torch.core.api import QueryPayload, QuerySpec
from repro_torch.core.master import MasterConfig
from repro_torch.core.worker import Executor, ExecRequest, SimExecutor
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.executor import EngineExecutor, EngineExecutorConfig
from repro_torch.sim.cluster import make_cluster

LLAMA = ARCHS["llama3.2-1b"]
PROMPTS = ((3, 1, 4, 1, 5, 9), (2, 7, 1, 8), (1, 6, 1, 8, 0, 3, 3, 9))
MAX_NEW = 4


def _done(q):
    return q.finish >= 0 and not q.failed


def _real(**kw):
    """A one-accel-worker real cluster on the CPU at reduced width."""
    return make_cluster(n_accel=1, archs=[LLAMA], autoscale=False,
                        cfg=kw.pop("cfg", MasterConfig(
                            worker_autoscale=False)),
                        backend="real", device="cpu", reduced=True, **kw)


def _executor(**kw):
    return EngineExecutor({LLAMA.name: LLAMA.reduced()},
                          EngineExecutorConfig(**kw), device="cpu")


def _oracle(ex, variant, prompts, max_new):
    """Tokens of a fresh engine on the served variant's own params, with
    the executor engine's geometry."""
    exec_eng = ex.engines[variant.name]
    model, params = ex.served_model(variant)
    eng = ServingEngine(model, params, max_batch=exec_eng.max_batch,
                        max_len=exec_eng.max_len,
                        decode_block=exec_eng.decode_block,
                        min_bucket=exec_eng.min_bucket,
                        page_size=exec_eng.page_size,
                        n_pages=exec_eng.n_pages)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.tokens for r in reqs]


# ----------------------------------------------------------------------
# mirrors of tests/test_executor_real.py


def test_sim_executor_is_the_default_and_satisfies_protocol():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    w = next(iter(c.master.workers.values()))
    assert isinstance(w.executor, SimExecutor)
    assert isinstance(w.executor, Executor)
    v = next(iter(c.store.registry.variants.values()))
    assert w.executor.run(v, 4) == pytest.approx(v.profile.latency(4))


def test_real_backend_serves_and_calibrates_profiles():
    """A mixed stream runs through selection into real engines, and at
    least one variant's m/c is re-fit from measured service times."""
    c = _real()
    before = {v.name: (v.profile.m, v.profile.c)
              for v in c.store.registry.variants.values()}
    assert all(v.profile.source == "analytic"
               for v in c.store.registry.variants.values())
    # one early query (a batch-1 job), then a burst that the worker's
    # adaptive batching packs into a larger job -> two distinct batch
    # sizes observed -> refit
    qs = [c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=600_000))]
    c.run_until(30.0)
    qs += [c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=600_000))
           for _ in range(7)]
    c.run_until(300.0)
    assert all(h.result(timeout=0.0).ok for h in qs)

    (ex,) = c.executors
    assert isinstance(ex, EngineExecutor) and ex.engines
    assert sum(e.stats["tokens_generated"]
               for e in ex.engines.values()) > 0
    batches = {b for obs in ex.observations.values() for b in obs}
    assert len(batches) >= 2, batches
    # one decision-log entry per run, with the run's segment occupancy
    assert len(ex.occupancy_log) == sum(
        len(ts) for obs in ex.observations.values() for ts in obs.values())
    assert all(0.0 < rec["slot_busy_frac"] <= 1.0 and rec["segments"] > 0
               for rec in ex.occupancy_log)
    measured = [v for v in c.store.registry.variants.values()
                if v.profile.source == "measured"]
    assert measured, "no profile was re-fit from measurements"
    for v in measured:
        assert (v.profile.m, v.profile.c) != before[v.name]
        assert v.profile.latency(1) > 0
        assert v.profile.peak_qps == pytest.approx(
            v.profile.max_batch / v.profile.latency(v.profile.max_batch))


def test_real_backend_queries_see_measured_latency():
    """Virtual-clock query latency reflects real measured service time,
    not the analytic roofline guess."""
    c = _real()
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=600_000))
    c.run_until(60.0)
    assert _done(h.query)
    obs = [t for per_b in c.executors[0].observations.values()
           for ts in per_b.values() for t in ts]
    assert obs
    assert h.query.finish - h.query.start == pytest.approx(obs[0])


@pytest.mark.parametrize("granularity", ["usecase", "variant"])
def test_query_redispatch_reselects(granularity):
    """A query that cannot be placed yet retries through selection — a
    use-case query via select_usecase, a variant-named one keeping the
    user's variant — and completes once capacity appears."""
    c = make_cluster(n_accel=0, n_cpu=0, archs=[LLAMA], autoscale=False)
    if granularity == "usecase":
        spec = QuerySpec.usecase("text-generation", "openwebtext",
                                 min_accuracy=0.5, latency_ms=600_000)
        vname = None
    else:
        vname = next(v.name for v in c.store.registry.variants.values()
                     if v.hardware == "h100-1")
        spec = QuerySpec.variant(vname, latency_ms=600_000)
    h = c.api.submit(spec)
    q = h.query
    if granularity == "usecase":
        assert q.task == "text-generation" and q.dataset == "openwebtext"
    # capacity appears only after the query has started retrying
    c.loop.schedule(0.6, lambda: c.master.add_worker("accel"))
    c.run_until(120.0)
    assert _done(q), (q.failed, q.finish)
    assert q.variant and q.variant == (vname or q.variant)


def test_variant_objects_stay_hashable():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    vs = list(c.store.registry.variants.values())
    assert len({v for v in vs}) == len(vs)
    assert vs[0] in {vs[0]}


def test_real_payload_outputs_bit_identical_to_direct_engine():
    """The reference's version rebuilds its oracle from the fp params
    while use-case selection serves the int8 sibling; here the oracle runs
    on the served variant's own params."""
    c = _real()
    h = c.api.submit(QuerySpec.usecase(
        "text-generation", "openwebtext", min_accuracy=0.5,
        latency_ms=600_000,
        payload=QueryPayload.of(PROMPTS, max_new_tokens=MAX_NEW)))
    res = h.result(timeout=600.0)
    assert res.ok, (res.failed, res.variant)
    variant = c.store.registry.variants[res.variant]
    assert variant.framework == "torch-int8"    # selection's default pick
    assert res.outputs is not None and len(res.outputs) == len(PROMPTS)
    for out in res.outputs:
        assert out.dtype == np.int32 and len(out) == MAX_NEW
    (ex,) = c.executors
    assert ex.served_model(variant) is ex._model(LLAMA.name, "int8")
    for want, got in zip(_oracle(ex, variant, PROMPTS, MAX_NEW),
                         res.outputs):
        np.testing.assert_array_equal(want, got)


def test_real_offline_payload_produces_outputs():
    c = _real()
    prompts = tuple(tuple(int(x) for x in np.arange(2 + (i % 3)) + i)
                    for i in range(6))
    h = c.api.submit(QuerySpec.arch(
        LLAMA.name, mode="offline",
        payload=QueryPayload.of(prompts, max_new_tokens=2)))
    res = h.result(timeout=600.0)
    assert res.ok and res.processed >= len(prompts)
    assert len(h.job.outputs) == len(prompts)
    for out in h.job.outputs:
        assert len(out) == 2


def test_sim_backend_payload_is_accounted_not_executed():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)
    h = c.api.submit(QuerySpec.arch(
        LLAMA.name, latency_ms=600_000,
        payload=QueryPayload.of(PROMPTS, max_new_tokens=MAX_NEW)))
    res = h.result(timeout=120.0)
    assert res.ok
    assert h.query.n_inputs == len(PROMPTS)
    assert res.outputs is None


@pytest.mark.parametrize("mode", ["online", "offline"])
def test_oversized_payload_fails_without_wedging_device(mode):
    """A payload past the engine's max_len fails its query (online) or its
    job, once, leaving the worker's offline queue (offline); the device
    keeps serving."""
    cfg = MasterConfig(worker_autoscale=False, max_retries=1,
                       retry_delay=0.1)
    c = _real(cfg=cfg)
    bad = c.api.submit(QuerySpec.arch(
        LLAMA.name, mode=mode,
        latency_ms=600_000 if mode == "online" else None,
        payload=QueryPayload.of([list(range(40))], max_new_tokens=4)))
    res = bad.result(timeout=300.0)
    assert res.failed and not res.ok
    if mode == "offline":
        w = next(iter(c.master.workers.values()))
        assert bad.job.failed and bad.job not in w.offline_jobs
    ok = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=600_000))
    assert ok.result(timeout=300.0).ok


def test_real_backend_without_payload_returns_no_outputs():
    c = _real()
    h = c.api.submit(QuerySpec.arch(LLAMA.name, latency_ms=600_000))
    res = h.result(timeout=300.0)
    assert res.ok and res.outputs is None


def test_payload_runs_do_not_refit_profiles():
    class _NoRunEngine:
        busy = False
        stats = {"busy_slot_steps": 0, "bubble_slot_steps": 0,
                 "decode_dispatches": 0}

        def warmup(self, prompt_lens=()):
            pass

        def submit(self, r):
            r.tokens = np.zeros(1, np.int32)

        def step(self):
            return 0

        def drain_completions(self):
            return []

    ex = _executor()
    v = next(iter(prof.generate_variants(LLAMA)))
    ex.engines[v.name] = _NoRunEngine()
    ex.run(v, 2, [ExecRequest(n_inputs=2, prompts=((1, 2), (3,)),
                              max_new_tokens=1)])
    assert v.name not in ex.observations          # payload run: excluded
    ex.run(v, 2, [ExecRequest(n_inputs=2)])
    assert list(ex.observations[v.name]) == [2]   # synthetic run: recorded


def test_engine_executor_lru_eviction_caps_engines():
    ex = _executor(max_engines=2, max_batch=2, max_len=16, decode_block=2,
                   min_bucket=4, prompt_len=4, max_new=2, page_size=8)
    v1, v2, v3 = list(prof.generate_variants(LLAMA))[:3]
    ex.run(v1, 1)
    ex.run(v2, 1)
    assert set(ex.engines) == {v1.name, v2.name} and ex.evictions == 0
    ex.run(v3, 1)                       # v1 is the LRU victim
    assert set(ex.engines) == {v2.name, v3.name}
    assert ex.evictions == 1
    ex.run(v2, 1)
    ex.run(v1, 1)                       # lazy rebuild of the evictee
    assert set(ex.engines) == {v2.name, v1.name}
    assert ex.evictions == 2
    outs = []
    ex.run(v1, 1, [ExecRequest(n_inputs=1, prompts=((1, 2, 3),),
                               max_new_tokens=2,
                               on_outputs=outs.append)])
    assert len(outs) == 1 and len(outs[0][0]) == 2


def test_engine_executor_paged_knobs_reach_engines():
    """page_size / n_pages flow through the executor into every lazily
    built engine; the default is the paged layout with 16-row pages."""
    ex = _executor(max_batch=2, max_len=16, decode_block=2, min_bucket=4,
                   prompt_len=4, max_new=2, page_size=8, n_pages=3)
    v = next(iter(prof.generate_variants(LLAMA)))
    ex.run(v, 1)
    eng = ex.engines[v.name]
    assert (eng.page_size, eng.n_pages) == (8, 3)
    assert EngineExecutorConfig().page_size == 16
    ex = _executor(max_batch=2, max_len=32, decode_block=2)
    ex.run(v, 1)
    eng = ex.engines[v.name]
    assert eng.page_size == 16
    assert eng.n_pages == eng.max_batch * eng.max_len // 16


# ----------------------------------------------------------------------
# the port's own surface


@pytest.mark.parametrize("knob,value", [
    ("prefix_cache", True), ("prefix_evict", "fifo"), ("speculate", "int8:2"),
    ("swap", "host"), ("swap_budget_bytes", 1 << 20),
    ("deadline_enforce", True), ("faults", object())])
def test_unported_executor_knobs_raise_by_name(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        _executor(**{knob: value})
    # and through the cluster factory, before any query runs
    with pytest.raises(NotImplementedError, match=knob):
        _real(engine_cfg=EngineExecutorConfig(**{knob: value}))


def test_executor_passes_chunk_threshold_to_its_engines():
    """``chunk_threshold`` reaches the engine, as in the reference's
    executor: payload prompts past it are seated for chunked prefill, and
    the tokens are an unchunked engine's."""
    prompts = PROMPTS + (tuple(range(1, 15)),)
    ex = _executor(max_batch=4, max_len=32, decode_block=2,
                   chunk_threshold=7)
    v = next(iter(prof.generate_variants(LLAMA)))
    outs = []
    ex.run(v, len(prompts), [ExecRequest(
        n_inputs=len(prompts), prompts=prompts, max_new_tokens=MAX_NEW,
        on_outputs=outs.append)])
    eng = ex.engines[v.name]
    assert eng.chunk_threshold == 7
    assert eng.stats["chunk_admits"] == 2          # the 8- and 14-token ones
    want = _oracle(ex, v, prompts, MAX_NEW)
    assert len(outs) == 1 and len(outs[0]) == len(prompts)
    for a, b in zip(outs[0], want):
        np.testing.assert_array_equal(a, b)


def test_executor_passes_admission_knobs_and_slo_to_its_engines():
    """``stage_slots``, ``admission``, ``preempt_policy`` and ``stream``
    reach the engine, ``ExecRequest.slo`` each engine request, and the
    streamed chunks reach the query's ``on_tokens`` sink in order,
    concatenating to its outputs."""
    ex = _executor(max_batch=2, max_len=32, decode_block=2, page_size=8,
                   n_pages=4, stage_slots=2, admission="optimistic",
                   preempt_policy="lru", stream=True)
    v = next(iter(prof.generate_variants(LLAMA)))
    ex.run(v, 1)                                # builds the engine
    eng = ex.engines[v.name]
    assert (eng.stage_slots, eng.admission, eng.preempt_policy,
            eng.stream) == (2, "optimistic", "lru", True)
    seen, outs, chunks = [], [], []
    submit = eng.submit
    eng.submit = lambda r: (seen.append(r), submit(r))
    ex.run(v, len(PROMPTS), [ExecRequest(
        n_inputs=len(PROMPTS), prompts=PROMPTS, max_new_tokens=MAX_NEW,
        slo=3.0, on_outputs=outs.append,
        on_tokens=lambda i, toks, t: chunks.append((i, list(toks))))])
    assert [r.slo for r in seen] == [3.0] * len(PROMPTS)
    for i, out in enumerate(outs[0]):
        assert [t for j, ts in chunks if j == i for t in ts] == \
            [int(x) for x in out]
    assert ex.occupancy_log[-1]["admissions_per_segment"] >= 0.0


def test_real_cluster_asks_for_cuda_unless_told_otherwise():
    import torch
    assert not torch.cuda.is_available()
    for n_accel in (0, 1):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_cluster(n_accel=n_accel, archs=[LLAMA], autoscale=False,
                         backend="real", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineExecutor({LLAMA.name: LLAMA.reduced()})
    # the sim backend runs no model and needs no device
    make_cluster(n_accel=1, archs=[LLAMA], autoscale=False)


def test_real_cluster_serves_full_width_unless_reduced():
    c = make_cluster(n_accel=1, archs=[LLAMA], autoscale=False,
                     backend="real", device="cpu")
    assert c.executors[0].arch_cfgs[LLAMA.name] == LLAMA
    c = _real()
    assert c.executors[0].arch_cfgs[LLAMA.name] == LLAMA.reduced()


def test_every_variant_runs_on_the_executor_device():
    """One device per executor, as in the reference: a cpu-host variant
    picked by selection runs where the executor's device is."""
    c = make_cluster(n_accel=0, n_cpu=1, archs=[LLAMA], autoscale=False,
                     cfg=MasterConfig(worker_autoscale=False),
                     backend="real", device="cpu", reduced=True)
    vname = next(v.name for v in c.store.registry.variants.values()
                 if v.hardware == "cpu-host" and "f32" in v.name)
    res = c.api.submit(QuerySpec.variant(
        vname, latency_ms=600_000,
        payload=QueryPayload.of(PROMPTS[:1], max_new_tokens=2))).result(
            timeout=600.0)
    assert res.ok and res.variant == vname
    (ex,) = c.executors
    assert ex.device.type == "cpu"
    assert ex.engines[vname].device == ex.device


# ----------------------------------------------------------------------
# real-backend parity against the reference


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_real_backend_tokens_equal_reference_cluster(dtype):
    """The same VariantTarget payload query through the JAX cluster and
    the port's, the port serving the JAX executor's own weights."""
    import jax  # noqa: F401  (the reference executor builds JAX params)
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro.core.api import QueryPayload as JPayload
    from repro.core.api import QuerySpec as JSpec
    from repro.core.master import MasterConfig as JMasterConfig
    from repro.sim.cluster import make_cluster as j_make_cluster
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model

    jc = j_make_cluster(n_accel=1, archs=[J_ARCHS[LLAMA.name]],
                        autoscale=False,
                        cfg=JMasterConfig(worker_autoscale=False),
                        backend="real")
    tc = _real()
    jv = f"{LLAMA.name}/tpu-v5e-1/{dtype}-b8"
    tv = f"{LLAMA.name}/h100-1/{dtype}-b8"
    (jex,), (tex,) = jc.executors, tc.executors
    # the port's executor serves the reference executor's weights
    quant = "none" if dtype == "bf16" else "int8"
    _, jparams = jex._model(LLAMA.name, quant)
    cfg = LLAMA.reduced()
    if quant == "int8":
        cfg = dataclasses.replace(cfg, quantize="int8")
    key = LLAMA.name if quant == "none" else f"{LLAMA.name}::int8"
    tex._models[key] = (build_model(cfg, "cpu"),
                        params_from_jax(jparams, device="cpu"))

    outs = []
    for api, spec_cls, payload_cls, name in (
            (jc.api, JSpec, JPayload, jv), (tc.api, QuerySpec, QueryPayload,
                                            tv)):
        res = api.submit(spec_cls.variant(
            name, latency_ms=600_000,
            payload=payload_cls.of(PROMPTS, max_new_tokens=MAX_NEW))).result(
                timeout=600.0)
        assert res.ok and res.variant == name
        outs.append(res.outputs)
    assert tex.served_model(tc.store.registry.variants[tv]) is \
        tex._models[key]
    for want, got in zip(*outs):
        np.testing.assert_array_equal(np.asarray(want), got)
