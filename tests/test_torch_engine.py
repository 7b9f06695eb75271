"""The port's paged serving engine against the JAX engine.

On one mixed stream (grouped admits with padding rows, a max_new == 1
request, prompts spanning several pages, admission gated on free pages)
the port engine, built on weights carried across from the JAX model, gives
the same greedy tokens and the same dispatch, step and slot-step counts as
``repro.serving.engine.ServingEngine(..., page_size=8)`` on
``llama3.2-1b`` reduced, for the fp and the int8 variant.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models.quantize import quantize_params_dense as j_quantize
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.serving.engine import PageAllocator, Request, ServingEngine, \
    bucket_len

KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4,
          page_size=8, n_pages=12)
COUNTS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
          "tokens_generated", "admitted", "peak_concurrency",
          "busy_slot_steps", "bubble_slot_steps")


def _stream(vocab, seed=3):
    rng = np.random.default_rng(seed)
    spec = [(5, 6), (6, 1), (7, 9), (29, 4), (12, 12), (4, 3), (16, 5),
            (9, 8)]
    return [(rng.integers(0, vocab, size=n).astype(np.int32), m)
            for n, m in spec]


def _engines(quant):
    jcfg = dataclasses.replace(J_ARCHS["llama3.2-1b"].reduced(),
                               quantize=quant)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if quant == "int8":
        jp = j_quantize(jp)
    tcfg = dataclasses.replace(T_ARCHS["llama3.2-1b"].reduced(),
                               quantize=quant)
    tm = t_build(tcfg, device="cpu")
    return (JEngine(jm, jp, **KW),
            ServingEngine(tm, params_from_jax(jp, device="cpu"), **KW))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_port_engine_matches_jax_engine(quant):
    jeng, teng = _engines(quant)
    stream = _stream(256)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(stream)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=m)
             for i, (p, m) in enumerate(stream)]
    jeng.serve(jreqs)
    teng.serve(treqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.tokens, jr.tokens, err_msg=str(tr.rid))
    for key in COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["prefill_dispatches"] < len(stream)   # grouped admits
    assert teng._alloc.n_free == teng.n_pages               # all returned
    assert (teng._bt == teng.n_pages).all()


def test_open_loop_submit_step_drain():
    _jeng, teng = _engines("none")
    (p0, m0), (p1, m1) = _stream(256)[:2]
    a = Request(rid=0, prompt=p0, max_new_tokens=m0)
    teng.submit(a)
    assert teng.step() > 0 and teng.busy
    b = Request(rid=1, prompt=p1, max_new_tokens=m1)
    teng.submit(b)                              # joins mid-stream
    while teng.busy:
        teng.step()
    done = teng.drain_completions()
    assert sorted(r.rid for r in done) == [0, 1]
    assert len(a.tokens) == m0 and len(b.tokens) == m1
    assert teng.drain_completions() == []
    assert 0.0 < teng.occupancy["slot_busy_frac"] <= 1.0


@pytest.mark.parametrize("knob", [
    dict(page_size=None), dict(chunk_threshold=8), dict(stage_slots=2),
    dict(admission="optimistic"), dict(prefix_cache=True),
    dict(swap="host"), dict(speculate=("draft", None)), dict(stream=True)])
def test_unported_knobs_raise(knob):
    tm = t_build(T_ARCHS["llama3.2-1b"].reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(tm, None, **dict(KW, **knob))


def test_engine_validates_requests_and_allocator_hygiene():
    tm = t_build(T_ARCHS["llama3.2-1b"].reduced(), device="cpu")
    eng = ServingEngine(tm, tm.init(0), **KW)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(rid=0, prompt=np.zeros(60, np.int32),
                           max_new_tokens=8))
    assert bucket_len(5, 4, 64) == 8 and bucket_len(1, 4, 64) == 4
    alloc = PageAllocator(4, 8)
    alloc.reserve(0, 17)                        # 3 pages worst case
    assert not alloc.can_reserve(9)
    assert alloc.cover(0, 9) == [0, 1] and alloc.cover(0, 64) == [2]
    with pytest.raises(ValueError, match="over-committed"):
        alloc.reserve(1, 9)
    alloc.release(0)
    assert alloc.n_free == 4 and alloc.committed == 0
