"""The port's paged serving engine against the JAX engine.

On one mixed stream (grouped admits with padding rows, a max_new == 1
request, prompts spanning several pages, admission gated on free pages)
the port engine, built on weights carried across from the JAX model, gives
the same greedy tokens and the same dispatch, step and slot-step counts as
``repro.serving.engine.ServingEngine(..., page_size=8)`` on
``llama3.2-1b`` reduced, for the fp and the int8 variant, and with
``chunk_threshold`` set, the same chunked admits.

Chunked prefill is held to the JAX model's serial greedy rollout (the
reference's own oracle) and must not stall an in-flight request; the audio
and vlm families clamp the knob off. The decode step's loop state lives on
the device: its mirrors on the host must agree after every segment, and
the warm-up that a CUDA graph capture runs must leave every pool and slot
bit-identical (run here as the plain body, which is what the card
captures). ``kernels.build`` credits a captured step's launches per
replay.
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
from repro_torch.kernels import build
from repro_torch.models import build_model as t_build
from repro_torch.serving.engine import PageAllocator, Request, ServingEngine, \
    bucket_len

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

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


@pytest.mark.parametrize("knob", [dict(spec_k=0)])
def test_unported_knobs_raise(knob):
    """Every knob of the JAX engine is ported (speculation last); a
    setting the engine cannot serve raises by name, as the JAX engine's
    does, rather than being ignored."""
    tm = t_build(T_ARCHS["llama3.2-1b"].reduced(), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tm, None, speculate=(tm, None), **dict(KW, **knob))


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


# ----------------------------------------------------------------------
# chunked prefill and the device-resident decode step

CHUNK_COUNTS = ("chunk_admits", "prefill_dispatches", "decode_dispatches",
                "decode_steps", "busy_slot_steps", "bubble_slot_steps",
                "admitted", "tokens_generated")
_LLAMA = {}


def _llama():
    """Reduced llama3.2-1b in f32: the JAX model and params, and the
    port's model on the same weights."""
    if not _LLAMA:
        jcfg = J_ARCHS["llama3.2-1b"].reduced()
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = t_build(T_ARCHS["llama3.2-1b"].reduced(), device="cpu")
        _LLAMA.update(jm=jm, jp=jp, tm=tm,
                      tp=params_from_jax(jp, device="cpu"))
    return _LLAMA


def _serial_greedy(model, params, prompt, max_new):
    """The reference's oracle: a full JAX forward per generated token."""
    toks = list(map(int, prompt))
    for _ in range(max_new):
        logits = model.forward(params,
                               {"tokens": jnp.asarray([toks], jnp.int32)})
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _mixed_stream(vocab, max_len=64, seed=3, n=6):
    """The reference's mixed stream: short prompts and one of 29 tokens,
    longer than a page and than the chunk threshold."""
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
                0, vocab, size=int(rng.integers(3, 12))).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 6)))
            for i in range(n - 1)]
    reqs.append(Request(rid=n - 1, prompt=rng.integers(
        0, vocab, size=29).astype(np.int32), max_new_tokens=4))
    return reqs


def test_chunked_prefill_matches_serial_greedy():
    """Prompts past the threshold are teacher-forced through the decode
    segments with no prefill dispatch, and every output is the serial
    greedy rollout's."""
    m = _llama()
    eng = ServingEngine(m["tm"], m["tp"], max_batch=3, max_len=64,
                        decode_block=4, min_bucket=4, page_size=8,
                        chunk_threshold=12)
    reqs = _mixed_stream(m["tm"].cfg.vocab)
    n_chunked = sum(len(r.prompt) > 12 for r in reqs)
    eng.serve(reqs)
    assert eng.stats["chunk_admits"] == n_chunked > 0
    assert eng.stats["prefill_dispatches"] < len(reqs) - n_chunked + 1
    for r in reqs:
        want = _serial_greedy(m["jm"], m["jp"], r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(r.tokens, np.asarray(want, np.int32),
                                      err_msg=f"rid={r.rid}")
    assert eng._alloc.n_free == eng.n_pages


def test_chunked_admission_mid_decode_does_not_stall():
    """A near-max_len prompt admitted mid-stream feeds inside the shared
    decode segments: the in-flight short request needs no extra segment,
    and both outputs stay exact."""
    m = _llama()
    vocab = m["tm"].cfg.vocab
    eng = ServingEngine(m["tm"], m["tp"], max_batch=2, max_len=64,
                        decode_block=4, min_bucket=4, page_size=8,
                        chunk_threshold=8)
    short = Request(rid=1, prompt=np.arange(5, dtype=np.int32) % vocab,
                    max_new_tokens=12)
    eng.submit(short)
    eng.step()                        # the first 4 of short's tokens
    long = Request(rid=2, prompt=np.arange(55, dtype=np.int32) % vocab,
                   max_new_tokens=4)
    eng.submit(long)                  # arrives mid-decode
    steps_for_short = 1
    while short.tokens is None:
        eng.step()
        steps_for_short += 1
    assert steps_for_short == 3, steps_for_short
    assert eng.stats["prefill_dispatches"] == 1     # short only
    assert eng.stats["chunk_admits"] == 1           # long, no prefill
    while eng.busy:
        eng.step()
    assert {r.rid for r in eng.drain_completions()} == {1, 2}
    for r in (short, long):
        want = _serial_greedy(m["jm"], m["jp"], r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(r.tokens, np.asarray(want, np.int32))


@pytest.mark.parametrize("threshold", [4, 8, 12])
def test_chunked_engine_matches_jax_engine(threshold):
    """The port with ``chunk_threshold`` against the JAX engine with it:
    the same greedy tokens and the same chunked admits, dispatches, decode
    steps and slot-steps, on a stream whose chunked prompts share segments
    with prefilled ones."""
    m = _llama()
    kw = dict(KW, chunk_threshold=threshold)
    jeng = JEngine(m["jm"], m["jp"], **kw)
    teng = ServingEngine(m["tm"], m["tp"], **kw)
    stream = _stream(256)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(stream)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(stream)]
    jeng.serve(jreqs)
    teng.serve(treqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.tokens, jr.tokens,
                                      err_msg=str(tr.rid))
    assert teng.stats["chunk_admits"] > 0
    for key in CHUNK_COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["decode_traces"] == 0     # nothing captured on a CPU
    assert teng.stats["graph_replays"] == 0


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_audio_and_vlm_never_chunk_and_stay_exact(arch):
    """Families whose prefill computes encoder KV clamp the knob off, as
    the JAX engine does: no chunked admit, and the unchunked tokens."""
    tm = t_build(T_ARCHS[arch].reduced(), device="cpu")
    params = tm.init(0)
    kw = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4,
              page_size=8)
    base = ServingEngine(tm, params, **kw)
    r_base = _mixed_stream(tm.cfg.vocab)
    base.serve(r_base)
    chunky = ServingEngine(tm, params, chunk_threshold=12, **kw)
    assert chunky.chunk_threshold is None
    r_chunky = _mixed_stream(tm.cfg.vocab)
    chunky.serve(r_chunky)
    assert chunky.stats["chunk_admits"] == 0
    for a, b in zip(r_base, r_chunky):
        np.testing.assert_array_equal(a.tokens, b.tokens,
                                      err_msg=f"rid={a.rid}")


def _state(eng):
    """Every pool and every piece of slot state, device and host."""
    t = {f"cache.{k}": v.clone() for k, v in eng._cache.items()}
    t.update(tok=eng._tok.clone(), pos=eng._pos.clone(),
             rem=eng._rem_dev.clone(), plen=eng._plen_dev.clone(),
             pbuf=eng._pbuf.clone(), out=eng._out.clone(),
             step_i=eng._step_i.clone(), bt=eng._bt_dev.clone())
    h = dict(rem=eng._rem.copy(), pos=eng._slot_pos.copy(),
             plen=eng._plen.copy(), bt=eng._bt.copy())
    return t, h


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base",
                                  "llama-3.2-vision-90b"])
def test_capture_warmup_leaves_pools_and_slots_bit_identical(arch):
    """Mid-serve, with live slots holding pages and a chunked prompt half
    fed, the warm-up steps a capture runs (every slot inactive, every
    block-table row at the sentinel, state restored) change no bit of any
    pool or of the slot state, and the serve then finishes with the
    tokens of an engine that never ran them."""
    tm = t_build(T_ARCHS[arch].reduced(), device="cpu")
    params = tm.init(0)
    kw = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4,
              page_size=8, chunk_threshold=12)
    outs = []
    for warm in (False, True):
        eng = ServingEngine(tm, params, **kw)
        rng = np.random.default_rng(4)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, tm.cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=m)
                for i, (n, m) in enumerate(((29, 6), (5, 10), (7, 12),
                                            (6, 3)))]
        for r in reqs:
            eng.submit(r)
        eng.step()
        if warm:
            assert all(r is not None for r in eng._slot_req)
            assert eng.stats["chunk_admits"] == (arch == "llama3.2-1b")
            before, host = _state(eng)
            eng._warm_steps()
            after, host_after = _state(eng)
            for k in before:
                assert torch.equal(before[k], after[k]), k
            for k in host:
                np.testing.assert_array_equal(host[k], host_after[k])
        while eng.busy:
            eng.step()
        outs.append([r.tokens for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold", [None, 8])
def test_device_loop_state_matches_host_mirrors_after_every_segment(
        threshold):
    """``rem``, ``pos`` and ``plen`` on the device equal the host's
    mirrors after every segment, for prefilled and chunked slots."""
    m = _llama()
    eng = ServingEngine(m["tm"], m["tp"], **dict(KW,
                                                 chunk_threshold=threshold))
    for i, (p, n) in enumerate(_stream(256)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    segments = 0
    while eng.busy:
        eng.step()
        segments += 1
        np.testing.assert_array_equal(eng._rem_dev.numpy(), eng._rem)
        np.testing.assert_array_equal(eng._pos.numpy(), eng._slot_pos)
        np.testing.assert_array_equal(eng._plen_dev.numpy(), eng._plen)
    assert segments > 3
    assert (eng.stats["chunk_admits"] > 0) == (threshold is not None)


def test_build_credits_captured_launches_per_replay():
    """A capture adds nothing to the launch counts; each credited replay
    adds what the capture recorded."""
    build.reset_launch_counts()
    build.check_launch("int8_matmul", 0)
    start = dict(build.launch_counts)
    with build.capturing() as delta:
        for _ in range(3):
            build.check_launch("int8_matmul", 0)
        build.check_launch("fused_paged_decode_attention", 0)
    assert build.launch_counts == start
    assert delta == {"int8_matmul": 3, "fused_paged_decode_attention": 1}
    build.credit(delta, 5)
    assert build.launch_counts["int8_matmul"] == start["int8_matmul"] + 15
    assert build.launch_counts["fused_paged_decode_attention"] == 5
    assert build.launch_counts["flash_attention"] == 0
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        build.check_launch("flash_attention", 7)
    build.reset_launch_counts()
