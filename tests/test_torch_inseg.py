"""In-segment admission in the port's engine against the JAX engine.

The staging ring lives inside the port's decode step (``_step_body``): a
slot that finishes mid-segment is logged and refilled from the ring in
place. On reduced llama3.2-1b, with the JAX model's weights carried across
by ``convert.params_from_jax`` and ``page_size`` 8, the port engine gives
the JAX engine's greedy tokens, completion order and staged, in-segment,
preemption, readmit, stall, dispatch, step and slot-step counts — on mixed
streams with ``stage_slots`` > 0 and with optimistic admission under a
tight pool, for the fp and int8 variants. The reference's
``test_inseg_admission.py`` is mirrored for the paged dense cases (audio
and vlm stand in for its ineligible families).

Port-only: the host segment plan (``plan_segment``), which sets how many
steps a captured graph replays, equals the step body's completion log over
a seeded fuzz of slot states and ring contents, and a capture's warm-up
steps leave every pool, ring and log buffer bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models.quantize import quantize_params_dense as j_quantize
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.serving.engine import Request, ServingEngine, plan_segment

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

# the counts the port must share with the JAX engine on the same stream
COUNTS = ("staged", "inseg_admissions", "preemptions", "preempt_readmits",
          "pressure_stalls", "prefill_dispatches", "decode_dispatches",
          "decode_steps", "busy_slot_steps", "bubble_slot_steps",
          "admitted", "chunk_admits", "tokens_generated", "peak_concurrency")

_BUILT = {}


def llama(quant="none"):
    """(JAX model, JAX params, port model, port params) of reduced
    llama3.2-1b, the port's weights carried across from the JAX init."""
    if quant not in _BUILT:
        jcfg = dataclasses.replace(J_ARCHS["llama3.2-1b"].reduced(),
                                   quantize=quant)
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        if quant == "int8":
            jp = j_quantize(jp)
        tcfg = dataclasses.replace(T_ARCHS["llama3.2-1b"].reduced(),
                                   quantize=quant)
        _BUILT[quant] = (jm, jp, t_build(tcfg, device="cpu"),
                         params_from_jax(jp, device="cpu"))
    return _BUILT[quant]


def stream(n=8, seed=3, prompt=(3, 10), max_new=(1, 6)):
    """Seeded (prompt, max_new) pairs: the reference tests' streams."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=int(rng.integers(*prompt))
                          ).astype(np.int32), int(rng.integers(*max_new)))
            for _ in range(n)]


def requests(cls, spec, **kw):
    return [cls(rid=i, prompt=p.copy(), max_new_tokens=m, **kw)
            for i, (p, m) in enumerate(spec)]


def drive(eng, reqs, hook=None):
    """Submit all, step until idle; ``hook(eng, n)`` runs after step n.
    Returns the rids in completion order."""
    for r in reqs:
        eng.submit(r)
    order, n = [], 0
    while eng.busy:
        eng.step()
        if hook is not None:
            hook(eng, n)
        n += 1
        order += [r.rid for r in eng.drain_completions()]
    return order


def both(spec, quant="none", hook=None, **kw):
    """Drive the JAX and the port engine on the same stream with the same
    knobs; hold tokens, completion order and counts equal. Returns (JAX
    engine, its requests, port engine, its requests)."""
    jm, jp, tm, tp = llama(quant)
    jeng = JEngine(jm, jp, **kw)
    teng = ServingEngine(tm, tp, **kw)
    jreqs, treqs = requests(JRequest, spec), requests(Request, spec)
    jorder, torder = drive(jeng, jreqs, hook), drive(teng, treqs, hook)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.tokens, jr.tokens,
                                      err_msg=f"rid={tr.rid}")
        assert tr.preemptions == jr.preemptions, tr.rid
    assert torder == jorder
    for key in COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    return jeng, jreqs, teng, treqs


def drained(eng):
    assert eng._alloc.n_free == eng.n_pages and eng._alloc.committed == 0
    assert (eng._bt == eng.n_pages).all()
    assert not eng._staged and not eng._preempted


PAGED = dict(min_bucket=4, page_size=8)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["staged", "optimistic", "optimistic+lru",
                                  "staged+chunked"])
def test_port_matches_jax_under_staging_and_pressure(quant, mode):
    """Mixed streams: the staging ring alone, optimistic admission on a
    pool of half the slots' worst case (slack victims, then LRU victims
    with a staging ring), and both with chunked prompts on a tighter
    pool."""
    kw = {"staged": dict(max_batch=2, max_len=64, decode_block=8,
                         stage_slots=4),
          "optimistic": dict(max_batch=4, max_len=64, decode_block=8,
                             n_pages=6, admission="optimistic"),
          "optimistic+lru": dict(max_batch=4, max_len=64, decode_block=4,
                                 n_pages=6, admission="optimistic",
                                 preempt_policy="lru", stage_slots=2),
          "staged+chunked": dict(max_batch=2, max_len=64, decode_block=4,
                                 n_pages=5, stage_slots=3,
                                 admission="optimistic",
                                 chunk_threshold=5)}[mode]
    spec = stream(10, seed=11, max_new=(6, 13))
    _, _, teng, _ = both(spec, quant, **dict(PAGED, **kw))
    s = teng.stats
    if "staged" in mode:
        assert s["staged"] > 0 and s["inseg_admissions"] > 0, s
    if mode.startswith("optimistic"):
        assert s["preemptions"] > 0 and s["pressure_stalls"] > 0, s
    if mode == "staged+chunked":
        assert s["chunk_admits"] > 0 and s["pressure_stalls"] > 0, s
    drained(teng)


def test_inseg_matches_boundary_bit_identical():
    """stage_slots on vs off on the paged layout: identical tokens, fewer
    prefill dispatches, the same admissions, the JAX engine's counts."""
    kw = dict(PAGED, max_batch=2, max_len=64, decode_block=8)
    _, _, boundary, r0 = both(stream(), stage_slots=0, **kw)
    assert boundary.stats["inseg_admissions"] == 0
    _, _, inseg, r1 = both(stream(), stage_slots=4, **kw)
    assert inseg.stats["inseg_admissions"] > 0
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=str(a.rid))
    assert inseg.stats["prefill_dispatches"] < \
        boundary.stats["prefill_dispatches"]
    assert inseg.stats["admitted"] == boundary.stats["admitted"] == len(r0)
    drained(inseg)


def _serial_greedy(model, params, prompt, max_new):
    """The reference tests' oracle: the JAX model's serial greedy rollout."""
    toks = list(map(int, prompt))
    for _ in range(max_new):
        logits = model.forward(params,
                               {"tokens": jnp.asarray([toks], jnp.int32)})
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_multi_completion_one_slot_one_segment():
    """Two short requests retired by one slot in one segment: the first
    prefills, the second is staged and pulled into the freed slot."""
    jm, jp, tm, tp = llama()
    spec = [(np.arange(4, dtype=np.int32), 3),
            (np.arange(3, dtype=np.int32), 3)]
    eng = ServingEngine(tm, tp, max_batch=1, max_len=64, decode_block=16,
                        stage_slots=2, **PAGED)
    reqs = requests(Request, spec)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert all(r.tokens is not None for r in reqs)
    s = eng.stats
    assert (s["decode_dispatches"], s["prefill_dispatches"],
            s["inseg_admissions"]) == (1, 1, 1), s
    assert [r.rid for r in eng.drain_completions()] == [0, 1]
    for r in reqs:
        np.testing.assert_array_equal(
            r.tokens, _serial_greedy(jm, jp, r.prompt, r.max_new_tokens))


def test_inseg_zero_added_dispatches_per_segment():
    """Decode dispatches == step() calls with the ring populated."""
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, max_batch=2, max_len=64, decode_block=8,
                        stage_slots=4, **PAGED)
    reqs = requests(Request, stream())
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
    assert eng.stats["decode_dispatches"] == steps
    assert eng.stats["inseg_admissions"] > 0


def test_inseg_mid_stream_submit_is_staged():
    """A request submitted while the only slot is busy is staged and
    admitted inside the next segment, with no prefill dispatch; both
    engines agree on every count."""
    spec = [(np.arange(5, dtype=np.int32), 4),
            (np.arange(3, dtype=np.int32), 2)]
    kw = dict(PAGED, max_batch=1, max_len=64, decode_block=16, stage_slots=2)
    jm, jp, tm, tp = llama()
    out = []
    for eng, cls in ((JEngine(jm, jp, **kw), JRequest),
                     (ServingEngine(tm, tp, **kw), Request)):
        r1, r2 = requests(cls, spec)
        eng.submit(r1)
        eng._admit_pending()                 # r1 takes the only slot
        eng.submit(r2)                       # arrives mid-decode
        pf = eng.stats["prefill_dispatches"]
        while eng.busy:
            eng.step()
        assert eng.stats["prefill_dispatches"] == pf
        assert eng.stats["staged"] == eng.stats["inseg_admissions"] == 1
        assert r2.admitted >= r2.arrival >= 0.0
        out.append(([r1.tokens, r2.tokens],
                    {k: eng.stats[k] for k in COUNTS}))
    (jt, js), (tt, ts) = out
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b, a)
    assert ts == js


def test_staged_request_not_stranded_by_sweep_freed_slot():
    """A max_new == 1 prefill finishes at admission and is swept at
    harvest; the staged request behind it is seated at the next boundary
    (no livelock), as in the JAX engine."""
    spec = [(np.arange(4, dtype=np.int32), 1),
            (np.arange(3, dtype=np.int32), 3)]
    _, _, teng, treqs = both(spec, max_batch=1, max_len=32, decode_block=8,
                             stage_slots=2, **PAGED)
    assert not teng.busy and all(r.tokens is not None for r in treqs)
    drained(teng)


def test_staged_requests_hold_page_reservations():
    """A staged request reserves its worst case at staging time, boundary
    admission cannot overcommit past it, and a full drain returns every
    page."""
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, max_batch=1, max_len=32, decode_block=8,
                        n_pages=4, stage_slots=4, **PAGED)
    # each request needs ceil((5 + 4 - 1) / 8) = 1 page
    reqs = requests(Request, [(np.arange(5, dtype=np.int32), 4)] * 6)
    for r in reqs:
        eng.submit(r)
    eng._admit_pending()
    assert eng._alloc.committed == 4
    assert len(eng._staged) == 3 and len(eng._pending) == 2
    assert all(len(eng._alloc.pages_of(t)) == 1 for _r, t, _b in eng._staged)
    order = []
    while eng.busy:
        eng.step()
        order += [r.rid for r in eng.drain_completions()]
    assert order == list(range(6))
    drained(eng)


@pytest.mark.parametrize("stage", [0, 4])
def test_occupancy_accounting_partitions_segments(stage):
    """busy + bubble slot-steps partition the segments' slot-steps, and
    admissions per segment count in-segment refills only."""
    _, _, teng, _ = both(stream(), stage_slots=stage, max_batch=2,
                         max_len=64, decode_block=16, **PAGED)
    s, occ = teng.stats, teng.occupancy
    assert s["busy_slot_steps"] + s["bubble_slot_steps"] == \
        s["decode_steps"] * teng.max_batch
    assert 0.0 < occ["slot_busy_frac"] <= 1.0
    assert occ["segments"] == s["decode_dispatches"]
    if stage:
        assert occ["admissions_per_segment"] > 0.0
        assert 0 < s["inseg_admissions"] <= s["admitted"]
    else:
        assert occ["admissions_per_segment"] == 0.0


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_staging_and_optimism_clamped_for_audio_and_vlm(arch):
    """The families whose prefill computes encoder KV cannot teacher-force
    staged prompts or replay a preempted prefix: the knobs clamp to
    boundary-only worst-case admission, preempt() refuses, and the tokens
    are the plain engine's."""
    cfg = T_ARCHS[arch].reduced()
    m = t_build(cfg, device="cpu")
    params = m.init(0)
    kw = dict(max_batch=2, max_len=64, decode_block=8, min_bucket=4,
              page_size=8)
    eng = ServingEngine(m, params, stage_slots=4, admission="optimistic",
                        **kw)
    assert eng.stage_slots == 0 and eng.admission == "worstcase"
    got = eng.serve(requests(Request, stream(4)))
    assert eng.stats["inseg_admissions"] == eng.stats["staged"] == 0
    want = ServingEngine(m, params, **kw).serve(requests(Request, stream(4)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    eng.submit(Request(rid=9, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=4))
    eng._admit_pending()
    with pytest.raises(ValueError, match="cannot recover"):
        eng.preempt(next(s for s, r in enumerate(eng._slot_req)
                         if r is not None))


def test_executor_threads_occupancy_into_decision_log():
    """EngineExecutor passes stage_slots through and appends a per-run
    occupancy record (the executor's decision log)."""
    from repro_torch.core import profiler as prof
    from repro_torch.serving.executor import (EngineExecutor,
                                              EngineExecutorConfig)
    acfg = T_ARCHS["llama3.2-1b"]
    v = next(x for x in prof.generate_variants(acfg)
             if x.hardware == "cpu-host")
    ex = EngineExecutor({acfg.name: acfg.reduced()},
                        EngineExecutorConfig(max_batch=2, max_len=32,
                                             decode_block=8, stage_slots=2),
                        device="cpu")
    ex.run(v, batch=4)
    eng = ex.engines[v.name]
    assert eng.stage_slots == 2 and eng.stats["inseg_admissions"] > 0
    rec = ex.occupancy_log[0]
    assert rec["variant"] == v.name and rec["segments"] >= 1
    assert 0.0 < rec["slot_busy_frac"] <= 1.0
    assert rec["admissions_per_segment"] > 0.0
    ex.run(v, batch=2)
    assert len(ex.occupancy_log) == 2


# ----------------------------------------------------------------------
# the port's own: the host plan against the device log, and quiescence


def _fuzz_engine():
    _, _, tm, tp = llama()
    return ServingEngine(tm, tp, max_batch=4, max_len=32, decode_block=6,
                         stage_slots=3, **PAGED)


def _random_state(eng, rng):
    """Random loop state on host mirrors and device alike, every block
    table row at the sentinel (so no KV write lands), and a random ring."""
    B = eng.max_batch
    rem = rng.integers(0, 5, B) * (rng.random(B) < 0.8)
    plen = np.where(rng.random(B) < 0.5, 0, rng.integers(1, 12, B))
    pos = rng.integers(0, 12, B)
    ring = [(int(rng.integers(1, 8)), int(rng.integers(1, 5)))
            for _ in range(int(rng.integers(0, eng.stage_slots + 1)))]
    for name, host, dev in (("rem", rem, eng._rem_dev),
                            ("pos", pos, eng._pos),
                            ("plen", plen, eng._plen_dev)):
        dev.copy_(torch.from_numpy(host.astype(np.int32)))
    eng._rem, eng._slot_pos, eng._plen = (a.astype(np.int64)
                                          for a in (rem, pos, plen))
    eng._pbuf.copy_(torch.from_numpy(
        rng.integers(0, 256, eng._pbuf.shape).astype(np.int32)))
    eng._staged.clear()
    for n, k in ring:
        eng._staged.append((Request(rid=0, prompt=rng.integers(
            0, 256, n).astype(np.int32), max_new_tokens=k), None,
            np.full((eng.pages_per_slot,), eng.n_pages, np.int32)))
    eng._ring_stale = True
    return ring


def test_segment_plan_equals_step_body_log_fuzz():
    """Over a seeded fuzz of slot states (idle, feeding a prompt, mid
    decode, one token from done) and ring contents, the host plan's step
    count, completion log, emissions and busy count equal what the step
    body does on the device (``_decode_segment`` raises otherwise), and
    the loop state after the segment is the plan's. A ring the plan does
    not know is caught."""
    eng = _fuzz_engine()
    rng = np.random.default_rng(0)
    n_refills = n_planned = 0
    for _trial in range(40):
        ring = _random_state(eng, rng)
        plan = plan_segment(eng._rem, eng._slot_pos, eng._plen, ring,
                            eng.decode_block)
        if not plan.n_steps:
            assert not (eng._rem > 0).any()
            continue
        n_planned += 1
        with torch.no_grad():
            out, log = eng._decode_segment(plan)
        np.testing.assert_array_equal(log, plan.log)
        n_refills += int(plan.log[:, 2].sum())
        for dev, want in ((eng._rem_dev, plan.rem), (eng._pos, plan.pos),
                          (eng._plen_dev, plan.plen)):
            np.testing.assert_array_equal(dev.numpy(), want)
        assert out.shape == (eng.max_batch, plan.n_steps)
    assert n_planned > 20 and n_refills > 5
    # the device ring holds one entry more than the plan: the check fires
    while True:
        ring = _random_state(eng, rng)
        plan = plan_segment(eng._rem, eng._slot_pos, eng._plen, ring,
                            eng.decode_block)
        if plan.n_steps and len(plan.log) > len(ring) and \
                len(ring) < eng.stage_slots:
            break
    eng._staged.append((Request(rid=0, prompt=np.arange(3, dtype=np.int32),
                                max_new_tokens=2), None,
                        np.full((eng.pages_per_slot,), eng.n_pages,
                                np.int32)))
    eng._ring_stale = True
    with pytest.raises(RuntimeError, match="diverged from its host plan"):
        with torch.no_grad():
            eng._decode_segment(plan)


def test_warm_steps_leave_pools_ring_and_log_bit_identical():
    """Mid-serve, with requests live, staged and the log written, the
    warm-up steps a capture runs change no bit of any pool, the slot
    state, the ring, the emitted tokens, the completion log or its
    counters."""
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, max_batch=2, max_len=64, decode_block=4,
                        stage_slots=2, chunk_threshold=5, **PAGED)
    for r in requests(Request, stream(8, seed=11, max_new=(3, 9))):
        eng.submit(r)
    for _ in range(20):                 # until a segment logged completions
        eng.step()                      # and requests are still staged
        if int(eng._n_comp[0]) and eng._staged:
            break
    eng._sync_ring()
    eng._sync_bt()
    assert eng._staged and int(eng._n_stage[0]) == len(eng._staged)
    assert int(eng._n_comp[0]) > 0
    state = lambda: [t.clone() for t in (  # noqa: E731
        *eng._cache.values(), eng._tok, eng._pos, eng._rem_dev,
        eng._plen_dev, eng._pbuf, eng._ring, eng._rb, eng._step_i,
        eng._bt_dev)]
    before = state()
    eng._warm_steps()
    for a, b in zip(before, state()):
        assert torch.equal(a, b)
    while eng.busy:
        eng.step()
    drained(eng)
