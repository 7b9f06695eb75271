"""Streaming in the port's engine against the JAX engine.

Mirrors the paged dense cases of the reference's ``test_streaming.py`` on
reduced llama3.2-1b (JAX weights carried across, ``page_size`` 8): partial
outputs at segment granularity are a view of the same generation — each
request's chunks come in emission order and concatenate to its tokens, the
chunks equal the JAX engine's chunk for chunk, time to first token lies
between arrival and completion, and a preempted request's replay never
re-streams what it handed out. End to end, an executor with ``stream``
set pushes chunks through worker -> ``Query.on_tokens`` -> ``QueryHandle``
on the control plane's virtual clock.
"""
import numpy as np

from test_torch_inseg import (PAGED, T_ARCHS, JEngine, JRequest, Request,
                              ServingEngine, llama, requests, stream)


def _run_streaming(eng, reqs, hook=None):
    """Drive to drain; returns chunks (rid, tokens, t) in emission order."""
    for r in reqs:
        eng.submit(r)
    chunks = []
    while eng.busy:
        eng.step()
        for r, toks, t in eng.drain_partial_outputs():
            chunks.append((r.rid, [int(x) for x in toks], t))
        if hook is not None:
            hook(eng)
    eng.drain_completions()
    assert eng.drain_partial_outputs() == []
    return chunks


def _concat(chunks, rid):
    return [t for r, toks, _ in chunks if r == rid for t in toks]


def _both(spec, hook=None, **kw):
    jm, jp, tm, tp = llama()
    out = []
    for eng, cls in ((JEngine(jm, jp, stream=True, **kw), JRequest),
                     (ServingEngine(tm, tp, stream=True, **kw), Request)):
        reqs = requests(cls, spec)
        out.append((eng, reqs, _run_streaming(eng, reqs, hook)))
    (_, jreqs, jchunks), (teng, treqs, tchunks) = out
    assert [(r, toks) for r, toks, _ in tchunks] == \
        [(r, toks) for r, toks, _ in jchunks]
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.tokens, jr.tokens)
    return teng, treqs, tchunks


def test_stream_concat_bit_identical():
    """Chunks concatenate to the final tokens, streaming does not perturb
    generation, and the JAX engine streams the same chunks."""
    kw = dict(PAGED, max_batch=3, max_len=64, decode_block=4)
    spec = stream(6, seed=7, max_new=(4, 10))
    _, _, tm, tp = llama()
    ref = ServingEngine(tm, tp, **kw).serve(requests(Request, spec))
    _, got, chunks = _both(spec, **kw)
    assert chunks
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert _concat(chunks, b.rid) == [int(x) for x in b.tokens]


def test_stream_under_staging_and_pressure_matches_jax():
    """The same with the staging ring and optimistic admission on a tight
    pool: refills and preemptions change neither the chunks nor their
    concatenation."""
    kw = dict(PAGED, max_batch=2, max_len=64, decode_block=4, n_pages=5,
              stage_slots=3, admission="optimistic", chunk_threshold=5)
    teng, got, chunks = _both(stream(10, seed=11, max_new=(6, 13)), **kw)
    assert teng.stats["inseg_admissions"] > 0
    assert teng.stats["pressure_stalls"] > 0
    for r in got:
        assert _concat(chunks, r.rid) == [int(x) for x in r.tokens]


def test_stream_emission_order_and_ttft_monotone():
    _, _, tm, tp = llama()
    eng = ServingEngine(tm, tp, stream=True, max_batch=3, max_len=64,
                        decode_block=4, **PAGED)
    got = requests(Request, stream(6, seed=7, max_new=(4, 10)))
    chunks = _run_streaming(eng, got)
    ts = [t for _, _, t in chunks]
    assert ts == sorted(ts)
    for r in got:
        mine = [t for rid, _, t in chunks if rid == r.rid]
        assert mine and r.first_token == mine[0]
        assert r.arrival <= r.first_token <= r.arrival + r.latency + 1e-6
    multi = [r for r in got if r.max_new_tokens > 4]
    assert any(r.first_token < r.arrival + r.latency for r in multi)


def test_preempt_replay_never_restreams():
    """Preempt a slot after it streamed a chunk: its replay hands out only
    the tokens past its cursor, as in the JAX engine."""
    victims = []

    def hook(eng):
        if len(victims) == (2 if isinstance(eng, ServingEngine) else 1):
            return
        live = [s for s in range(eng.max_batch)
                if eng._slot_req[s] is not None
                and 0 < eng._slot_req[s].streamed
                < eng._slot_req[s].max_new_tokens]
        if live:
            victims.append(eng._slot_req[live[0]])
            eng.preempt(live[0])

    kw = dict(PAGED, max_batch=2, max_len=64, decode_block=4)
    _, got, chunks = _both(stream(6, seed=7, max_new=(8, 12)), hook=hook,
                           **kw)
    assert len(victims) == 2 and victims[1].preemptions == 1
    assert victims[0].rid == victims[1].rid
    for r in got:
        cat = _concat(chunks, r.rid)
        assert cat == [int(x) for x in r.tokens]


def test_streaming_through_control_plane_virtual_clock():
    """End to end under the deterministic event loop: an executor with
    ``stream=True`` pushes chunks to the query handle in order, a late
    subscriber replays them, their concatenation is ``result().outputs``
    and ``ttft`` <= latency."""
    from repro_torch.core.api import QueryPayload, QuerySpec
    from repro_torch.serving.executor import EngineExecutorConfig
    from repro_torch.sim.cluster import make_cluster
    arch = T_ARCHS["llama3.2-1b"]
    c = make_cluster(n_accel=1, archs=[arch], autoscale=False,
                     backend="real", device="cpu", reduced=True,
                     engine_cfg=EngineExecutorConfig(
                         max_batch=4, max_len=48, decode_block=4,
                         stream=True))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=6), rng.integers(0, 256, size=9)]
    h = c.api.submit(QuerySpec.arch(
        arch.name, latency_ms=600_000,
        payload=QueryPayload.of(prompts, max_new_tokens=10)))
    live = []
    h.on_tokens(live.append)
    res = h.result(timeout=600.0)
    assert res.ok and res.outputs is not None and live
    ts = [ch.t for ch in live]
    assert ts == sorted(ts)
    for idx, out in enumerate(res.outputs):
        cat = [t for ch in live if ch.input_idx == idx for t in ch.tokens]
        assert cat == [int(x) for x in out]
    replay = []
    h.on_tokens(replay.append)
    assert replay == live and len(h.chunks) == len(live)
    assert h.ttft is not None and 0.0 <= h.ttft <= res.latency + 1e-9
