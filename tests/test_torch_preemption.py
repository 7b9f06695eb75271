"""Optimistic admission, preemption and cancellation in the port's engine
against the JAX engine.

Mirrors the paged dense cases of the reference's ``test_preemption.py``
and the two cancel tests of its ``test_swap.py`` on reduced llama3.2-1b
(JAX weights carried across, ``page_size`` 8): a preempted request frees
its pages, parks with its prompt and generated tokens, replays that prefix
through the decode segments and finishes with the tokens of an
uninterrupted run; optimistic admission on a pool of half the worst-case
demand reaches higher concurrency and matches the uncontended reference;
every such stream gives the JAX engine's tokens, completion order and
counts. Requests carry no SLO wherever the victim choice is compared with
the JAX engine (slack ties then break on preemptions, positions left and
slot, which are deterministic); the slack policy's protection of a tight
SLO is held on the port alone.
"""
import time

import numpy as np
import pytest
import torch

from test_torch_inseg import (PAGED, T_ARCHS, Request, ServingEngine, both,
                              drained, llama, requests, stream)

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)


def _first_live(eng):
    return next(s for s in range(eng.max_batch)
                if eng._slot_req[s] is not None)


@pytest.mark.parametrize("stage", [0, 2])
def test_forced_preempt_recovers_bit_identical(stage):
    """Preempt a live slot after one segment; the parked request replays
    its prefix and finishes with an uninterrupted run's tokens."""
    kw = dict(PAGED, max_batch=2, max_len=64, decode_block=4)
    spec = stream(6, seed=11, max_new=(4, 9))
    _, _, ref, want = both(spec, **kw)

    def hook(eng, n):
        if n == 0:
            eng.preempt(_first_live(eng))

    _, _, eng, got = both(spec, hook=hook, stage_slots=stage, **kw)
    assert eng.stats["preemptions"] == eng.stats["preempt_readmits"] == 1
    assert sum(r.preemptions for r in got) == 1
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=str(a.rid))
    drained(eng)


def test_preempt_mid_chunked_prefill_recovers():
    """Preempting a slot still feeding its prompt parks a pure-prompt
    prefix; recovery restarts the chunked prefill from scratch."""
    kw = dict(PAGED, max_batch=1, max_len=64, decode_block=4,
              chunk_threshold=8)
    spec = [((np.arange(20, dtype=np.int32) * 3 + 1) % 256, 5)]
    _, _, ref, (want,) = both(spec, **kw)
    assert ref.stats["chunk_admits"] == 1
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, **kw)
    (got,) = requests(Request, spec)
    eng.submit(got)
    eng.step()                              # one 4-position chunk
    assert got.tokens is None
    eng.preempt(0)
    assert eng._preempted and len(eng._preempted[0].done) == 0
    assert int(eng._rem_dev[0]) == 0        # deactivated on the device
    while eng.busy:
        eng.step()
    assert got.preemptions == 1
    np.testing.assert_array_equal(got.tokens, want.tokens)
    drained(eng)


def test_optimistic_beats_worstcase_concurrency_bit_identical():
    """On a pool of about half the slots' worst case, optimistic admission
    serves more requests at once than worst-case admission, completes the
    stream and matches the big-pool reference."""
    kw = dict(PAGED, max_batch=4, max_len=64, decode_block=8)
    spec = stream(10, seed=11, max_new=(6, 13))
    _, _, ref, want = both(spec, n_pages=12, **kw)
    _, _, wc, got_wc = both(spec, n_pages=6, **kw)
    _, _, opt, got = both(spec, n_pages=6, admission="optimistic", **kw)
    for a, b, c in zip(want, got_wc, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(c.tokens, a.tokens)
    s = opt.stats
    assert s["peak_concurrency"] > wc.stats["peak_concurrency"]
    assert s["preemptions"] > 0 and s["pressure_stalls"] > 0
    assert s["preempt_readmits"] == s["preemptions"]
    drained(opt)


def test_optimistic_pressure_with_staging_ring():
    """Pressure relief un-stages before it preempts, and the in-segment
    refill stays exact on an over-committed pool."""
    kw = dict(PAGED, max_batch=2, max_len=64, decode_block=8)
    spec = stream(8, seed=11, max_new=(6, 13))
    _, _, ref, want = both(spec, **kw)
    _, _, eng, got = both(spec, n_pages=4, stage_slots=2,
                          admission="optimistic", **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    assert eng.stats["pressure_stalls"] > 0 and eng.stats["staged"] > 0
    drained(eng)


def test_slack_policy_protects_tight_slo():
    """With one no-SLO and one tight-SLO request live, pressure preempts
    the no-SLO one (infinite slack); ``lru`` preempts the most recently
    admitted instead."""
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, max_batch=2, max_len=64, decode_block=8,
                        **PAGED)
    loose = Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                    max_new_tokens=6, slo=None)
    tight = Request(rid=1, prompt=np.arange(5, dtype=np.int32),
                    max_new_tokens=6, slo=0.001)
    eng.submit(loose)
    eng.submit(tight)
    eng._admit_pending()
    slots = {eng._slot_req[s].rid: s for s in range(2)}
    assert eng._pick_victim(exclude=-1) == slots[0]
    eng.preempt_policy = "lru"
    assert eng._pick_victim(exclude=-1) == slots[1]
    eng.preempt_policy = "slack"
    eng.preempt(slots[0])
    assert loose.preemptions == 1 and eng.busy
    while eng.busy:
        eng.step()
    assert len(loose.tokens) == len(tight.tokens) == 6
    drained(eng)


def test_admission_knob_validation():
    _, _, tm, tp = llama()
    with pytest.raises(ValueError, match="admission"):
        ServingEngine(tm, tp, admission="hopeful")
    with pytest.raises(ValueError, match="preempt policy"):
        ServingEngine(tm, tp, preempt_policy="random")
    eng = ServingEngine(tm, tp, admission="optimistic", preempt_policy="lru",
                        stage_slots=3, stream=True)
    assert (eng.admission, eng.preempt_policy, eng.stage_slots,
            eng.stream) == ("optimistic", "lru", 3, True)
    with pytest.raises(ValueError, match="not live"):
        eng.preempt(0)
    with pytest.raises(ValueError, match="not live"):
        eng.cancel(0)


def test_executor_surfaces_preemptions_and_degraded():
    """EngineExecutor on a starved optimistic pool: the decision log
    carries preemption and pressure-stall counts, the monotone pressure
    total tracks them, and ``on_report`` delivers the degraded verdict."""
    from repro_torch.core import profiler as prof
    from repro_torch.core.worker import ExecRequest
    from repro_torch.serving.executor import (EngineExecutor,
                                              EngineExecutorConfig)
    acfg = T_ARCHS["llama3.2-1b"]
    v = next(x for x in prof.generate_variants(acfg)
             if x.hardware == "cpu-host")
    ex = EngineExecutor(
        {acfg.name: acfg.reduced()},
        EngineExecutorConfig(max_batch=4, max_len=64, decode_block=8,
                             min_bucket=4, page_size=8, n_pages=6,
                             admission="optimistic"), device="cpu")
    reports, outs = [], []
    rng = np.random.default_rng(5)
    prompts = tuple(rng.integers(0, 256, size=int(p)).astype(np.int32)
                    for p in rng.integers(4, 10, size=8))
    ex.run(v, batch=len(prompts), requests=[ExecRequest(
        n_inputs=len(prompts), prompts=prompts, max_new_tokens=10, slo=5.0,
        on_outputs=outs.append, on_report=reports.append)])
    eng = ex.engines[v.name]
    assert eng.admission == "optimistic"
    rec = ex.occupancy_log[-1]
    assert rec["preemptions"] == eng.stats["preemptions"] > 0
    assert rec["pressure_stalls"] == eng.stats["pressure_stalls"]
    assert ex.pressure_events_total == \
        rec["preemptions"] + rec["pressure_stalls"]
    assert reports[0]["preemptions"] >= 1 and reports[0]["degraded"]
    assert not reports[0]["timed_out"]
    # the preempted work recovered: the tokens of a roomy engine
    roomy = ServingEngine(eng.model, eng.params, max_batch=4, max_len=64,
                          decode_block=8, min_bucket=4, page_size=8)
    want = roomy.serve([Request(rid=i, prompt=p, max_new_tokens=10)
                        for i, p in enumerate(prompts)])
    for a, b in zip(want, outs[0]):
        np.testing.assert_array_equal(b, a.tokens)


# ----------------------------------------------------------------------
# cancellation (the reference's ``test_swap.py`` cancel tests)


def test_cancel_frees_slot_and_keeps_partial_tokens():
    """``cancel`` frees a live slot now and completes its request with the
    tokens it has; the others finish whole, as in the JAX engine."""
    kw = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4,
              page_size=8)
    spec = stream(2, seed=11, max_new=(20, 21))
    victim = {}

    def hook(eng, n):
        if n == 0:
            s = _first_live(eng)
            victim[type(eng).__module__] = eng._slot_req[s]
            eng.cancel(s)
            assert eng._slot_req[s] is None

    _, _, eng, got = both(spec, hook=hook, **kw)
    r = victim[ServingEngine.__module__]
    assert r.cancelled and 0 < len(r.tokens) < r.max_new_tokens
    for q in got:
        if q is not r:
            assert not q.cancelled and len(q.tokens) == q.max_new_tokens
    assert eng.stats["tokens_generated"] == sum(len(q.tokens) for q in got)
    drained(eng)


def test_cancel_overdue_sweeps_live_and_pending():
    """A live slot past its SLO keeps its partial tokens, queued requests
    complete with none; every request resolves and the pool drains."""
    out = []
    from test_torch_inseg import JEngine, JRequest
    jm, jp, tm, tp = llama()
    kw = dict(max_batch=1, max_len=64, decode_block=4, min_bucket=4,
              page_size=8)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, size=5).astype(np.int32)
               for _ in range(3)]
    for eng, cls in ((JEngine(jm, jp, **kw), JRequest),
                     (ServingEngine(tm, tp, **kw), Request)):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=20, slo=0.5)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        assert eng.cancel_overdue(now=time.perf_counter() + 60.0) == 3
        assert [r.rid for r in eng.drain_completions()] == [0, 1, 2]
        assert all(r.cancelled for r in reqs)
        assert len(reqs[0].tokens) > 0
        assert all(len(r.tokens) == 0 for r in reqs[1:])
        assert not eng.busy
        assert eng._alloc.n_free == eng.n_pages
        assert eng._alloc.committed == 0
        out.append([r.tokens for r in reqs])
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)


def test_cancel_overdue_completes_parked_with_generated_tokens():
    """A parked (preempted) request past its SLO completes with the tokens
    it generated before the preemption; one without an SLO is kept."""
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, max_batch=2, max_len=64, decode_block=4,
                        **PAGED)
    a = Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                max_new_tokens=12, slo=0.5)
    b = Request(rid=1, prompt=np.arange(6, dtype=np.int32),
                max_new_tokens=12)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    done = list(eng._gen[eng._slot_req.index(a)])
    eng.preempt(eng._slot_req.index(a))
    assert eng.cancel_overdue(now=time.perf_counter() + 60.0) == 1
    assert a.cancelled and list(a.tokens) == done and len(done) > 0
    assert not eng._preempted
    while eng.busy:
        eng.step()
    assert not b.cancelled and len(b.tokens) == 12
    drained(eng)
