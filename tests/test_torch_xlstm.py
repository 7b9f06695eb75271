"""The ssm family (xlstm-1.3b: mLSTM and sLSTM blocks, no attention) in the
port against the JAX package, reduced size, f32, on the CPU.

Cell level: the mLSTM cases of the reference's ``test_property_models.py``
with hypothesis (the chunked form equals the recurrent one; the state
carried across two calls equals one call), and each cell against its
``repro.models.xlstm`` counterpart on the same seeded inputs:
``mlstm_chunked``, ``mlstm_recurrent`` and ``slstm_scan`` with a
right-padding mask. Model level: ``prefill_xlstm``/``decode_xlstm`` logits
and all seven state leaves against ``repro``'s on converted weights; the
reference's prefill/decode smoke case; the empty state (-1e30 stabilizers,
1e-6 normalizer) against ``repro``'s and the scan defaults; the
recurrent form's prefill against the prompt fed from the empty state;
``param_count`` against the initialised tree and the reference's formula.

Engine level, mirroring the xlstm cases of the reference's
``test_serving_engine.py``, ``test_engine_open_loop.py``,
``test_paged_engine.py`` (with ``test_attention_free_family_ignores_paging``),
``test_inseg_admission.py`` (with the chunked-prefill and empty-state
tests), ``test_preemption.py``, ``test_streaming.py`` and ``test_swap.py``:
each stream is served once by the JAX engine (memoized per module,
``test_torch_layout.jax_run``) and the port engine must give its tokens
and counts. Port-only: a seat and the step body's ring refill write the
-1e30 rows, and the capture's warm-up steps leave the state as it was.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import xlstm as JX
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.models import xlstm as X
from repro_torch.serving.engine import Request, ServingEngine
from test_torch_hybrid import (_inseg_stream, _preempt_once, _serial_greedy,
                               _serving_stream)
from test_torch_layout import (assert_counts, assert_tokens, built,
                               jax_run, mixed_stream, port_run, requests)

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

ARCH = "xlstm-1.3b"
# f32 sums taken in another order by two frameworks; the recurrent states
# sum many terms, so they are held relative to their size
TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's tolerance for chunked against recurrent f32 sums
PROP = dict(rtol=2e-4, atol=2e-4)
KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4)
LEAVES = ("mC", "mn", "mm", "sh", "sc", "sn", "sm")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cell_inputs(rng, b, S, h, d):
    q, k, v = (rng.normal(size=(b, S, h, d)).astype(np.float32)
               for _ in range(3))
    li = rng.normal(size=(b, S, h)).astype(np.float32)
    lf = (-np.abs(rng.normal(size=(b, S, h))) - 0.05).astype(np.float32)
    return q, k, v, li, lf


# ---------------------------------------------------------------------------
# the cells


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**31 - 1),
       st.sampled_from([(16, 4), (32, 8), (64, 16), (32, 32)]),
       st.integers(1, 2), st.integers(1, 2))
def test_mlstm_chunked_matches_recurrent(seed, s_chunk, b, h):
    S, chunk = s_chunk
    q, k, v, li, lf = (_t(a) for a in _cell_inputs(
        np.random.default_rng(seed), b, S, h, 8))
    h_chunk, (C1, n1, m1) = X.mlstm_chunked(q, k, v, li, lf, chunk)
    h_rec, (C2, n2, m2) = X.mlstm_recurrent(q, k, v, li, lf)
    np.testing.assert_allclose(h_chunk.numpy(), h_rec.numpy(), **PROP)
    # the carried state is stabilizer-normalized: compare in true space
    np.testing.assert_allclose(
        (C1 * torch.exp(m1)[..., None, None]).numpy(),
        (C2 * torch.exp(m2)[..., None, None]).numpy(), rtol=2e-3, atol=2e-3)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_mlstm_state_carry_across_calls(seed):
    """Splitting a sequence across two chunked calls == one call."""
    q, k, v, li, lf = (_t(a) for a in _cell_inputs(
        np.random.default_rng(seed), 1, 32, 2, 8))
    full, _ = X.mlstm_chunked(q, k, v, li, lf, 8)
    h1, st1 = X.mlstm_chunked(q[:, :16], k[:, :16], v[:, :16], li[:, :16],
                              lf[:, :16], 8)
    h2, _ = X.mlstm_chunked(q[:, 16:], k[:, 16:], v[:, 16:], li[:, 16:],
                            lf[:, 16:], 8, state=st1)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(),
                               **PROP)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_cells_match_repro(with_state):
    """``mlstm_chunked`` (two chunks) and ``mlstm_recurrent`` against
    ``repro``'s on the same inputs, from the empty state and from a
    carried one."""
    rng = np.random.default_rng(3)
    ins = _cell_inputs(rng, 2, 16, 2, 8)
    state = None
    jstate = None
    if with_state:
        _, jstate = JX.mlstm_chunked(*(jnp.asarray(a) for a in ins), 8)
        state = tuple(_t(a) for a in jstate)
    jh, js = JX.mlstm_chunked(*(jnp.asarray(a) for a in ins), 8,
                              state=jstate)
    th, ts = X.mlstm_chunked(*(_t(a) for a in ins), 8, state=state)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jh, js = JX.mlstm_recurrent(*(jnp.asarray(a) for a in ins),
                                state=jstate)
    th, ts = X.mlstm_recurrent(*(_t(a) for a in ins), state=state)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_slstm_scan_with_padding_mask_matches_repro():
    """``slstm_scan`` over right-padded rows: the hidden states and the
    final carry (frozen at the last valid step) equal ``repro``'s; a row
    padded past its length ends with the carry of that length."""
    rng = np.random.default_rng(4)
    B, S, H, hd = 3, 12, 2, 8
    d = H * hd
    xg = rng.normal(size=(B, S, 4 * d)).astype(np.float32)
    r = (rng.normal(size=(4, H, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    bias = rng.normal(size=(4 * d,)).astype(np.float32)
    lens = np.array([12, 7, 1])
    mask = np.arange(S)[None, :] < lens[:, None]
    jh, js = JX.slstm_scan(jnp.asarray(xg), jnp.asarray(r),
                           jnp.asarray(bias), H, mask=jnp.asarray(mask))
    th, ts = X.slstm_scan(_t(xg), _t(r), _t(bias), H,
                          mask=torch.from_numpy(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # row 1 stops at 7: its carry is that of an unpadded 7-step scan (a
    # one-row product may round its sums otherwise)
    _, short = X.slstm_scan(_t(xg[1:2, :7]), _t(r), _t(bias), H)
    for a, b in zip(ts, short):
        np.testing.assert_allclose(a[1:2].numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# model level


def _prompts(vocab, lens, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, vocab, size=n)
    return toks


def test_prefill_decode_logits_and_state_match_repro():
    """Prefill of right-padded prompts (the masked mLSTM gates and the
    frozen sLSTM carry), then three decode steps: logits and all seven
    state leaves equal ``repro``'s within f32 tolerance."""
    jm, jp, tm, tp = built(ARCH)
    cfg = tm.cfg
    lens = np.array([16, 11], np.int32)
    toks = _prompts(cfg.vocab, lens, 16)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "length": jnp.asarray(lens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "length": torch.from_numpy(lens)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    assert set(tc) == set(LEAVES)
    for name in LEAVES:
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   err_msg=name, **TOL)
    rng = np.random.default_rng(1)
    pos = lens.copy()
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tok),
                           torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        for name in LEAVES:
            np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                       err_msg=name, **TOL)
        pos = pos + 1


def test_prefill_decode_smoke():
    """The xlstm case of the reference's ``test_prefill_decode_smoke``:
    finite logits of the vocabulary's width, state leaves of
    ``cache_shapes``' shapes (no sequence axis: independent of max_len),
    and no decode window."""
    _, _, tm, tp = built(ARCH)
    cfg = tm.cfg
    toks = torch.from_numpy(_prompts(cfg.vocab, [16, 16], 16)).long()
    logits, cache = tm.prefill(tp, {"tokens": toks})
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    shapes = tm.cache_shapes(2, 16)
    assert shapes == tm.cache_shapes(2, 64)
    for name, (sh, dt) in shapes.items():
        assert tuple(cache[name].shape) == sh and cache[name].dtype == dt
    logits2, _ = tm.decode(tp, cache, toks[:, -1:],
                           torch.full((2,), 16, dtype=torch.int32))
    assert logits2.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits2).all())
    assert tm.decode_window is None


def test_empty_state_is_repro_s_and_the_scan_defaults():
    """``Model.empty_state`` holds ``repro``'s ``xlstm_empty_state`` rows
    (-1e30 stabilizers, the 1e-6 normalizer, zeros elsewhere), and they
    are the states the cells start from with ``state=None``: one decode
    from them equals one from the cells' own defaults."""
    _, _, tm, tp = built(ARCH)
    cfg = tm.cfg
    empty = tm.empty_state(2, 64)
    want = JX.xlstm_empty_state(J_ARCHS[ARCH].reduced(), 2)
    for name in LEAVES:
        np.testing.assert_array_equal(_np(empty[name]),
                                      np.asarray(want[name]), err_msg=name)
    neg, floor = float(np.float32(-1e30)), float(np.float32(1e-6))
    assert float(empty["mm"].max()) == float(empty["sm"].max()) == neg
    assert float(empty["sn"].min()) == float(empty["sn"].max()) == floor
    d, H = cfg.d_model, cfg.n_heads
    m0 = X._mlstm_state0(2, H, cfg.head_dim, "cpu")
    s0 = X.slstm_state0(2, d, "cpu")
    for got, ref in zip([empty[n][0] for n in LEAVES], m0 + s0):
        assert torch.equal(got, ref)


def test_empty_state_seeded_rollout_matches_prefill():
    """The reference's ``test_xlstm_empty_state_matches_scan_defaults``: a
    greedy rollout that teacher-forces the prompt through decode from the
    empty state equals prefill + decode."""
    _, _, tm, tp = built(ARCH)
    prompt = [3, 5, 2, 7]
    with torch.no_grad():
        cache = tm.empty_state(1, 64)
        pos = torch.zeros((1,), dtype=torch.int32)
        for t in prompt:
            logits, cache = tm.decode(tp, cache, torch.tensor([[t]]), pos)
            pos = pos + 1
        got = [int(torch.argmax(logits[0, -1]))]
        for _ in range(3):
            logits, cache = tm.decode(tp, cache, torch.tensor([[got[-1]]]),
                                      pos)
            pos = pos + 1
            got.append(int(torch.argmax(logits[0, -1])))
        logits, cache = tm.prefill(tp, {"tokens": torch.tensor([prompt])})
        want = [int(torch.argmax(logits[0, -1]))]
        pos = torch.tensor([len(prompt)], dtype=torch.int32)
        for _ in range(3):
            logits, cache = tm.decode(tp, cache,
                                      torch.tensor([[want[-1]]]), pos)
            pos = pos + 1
            want.append(int(torch.argmax(logits[0, -1])))
    assert got == want


@pytest.mark.parametrize("lens", [[16, 16], [16, 9]])
def test_recurrent_prefill_equals_feed_from_empty_state(lens):
    """``prefill_xlstm(mode="recurrent")`` (each cell from its own
    zero-token state; right padding masked) gives the logits and all
    seven state leaves of the prompts fed one token a step through decode
    from ``empty_state``, within f32 tolerance; with equal lengths, where
    the feed stops with every prompt, the chunked form's too."""
    _, _, tm, tp = built(ARCH)
    cfg = tm.cfg
    toks = torch.from_numpy(_prompts(cfg.vocab, lens, 16)).long()
    n = torch.tensor(lens)
    with torch.no_grad():
        rec, rc = X.prefill_xlstm(cfg, tp, toks, n, mode="recurrent")
        chunked, cc = X.prefill_xlstm(cfg, tp, toks, n)
        cache = tm.empty_state(2, 64)
        fed = torch.zeros_like(rec)
        for t in range(16):
            logits, cache = tm.decode(tp, cache, toks[:, t:t + 1],
                                      torch.full((2,), t, dtype=torch.int32))
            fed = torch.where((n - 1 == t)[:, None, None], logits, fed)
    np.testing.assert_allclose(_np(rec), _np(fed), **TOL)
    np.testing.assert_allclose(_np(rec), _np(chunked), **PROP)
    for name in LEAVES:
        np.testing.assert_allclose(_np(rc[name]), _np(cc[name]),
                                   err_msg=name, **PROP)
        if lens[0] == lens[1]:
            np.testing.assert_allclose(_np(rc[name]), _np(cache[name]),
                                       err_msg=name, **TOL)


def test_param_count_against_the_tree_and_repro():
    """The port counts the initialised tree (norm scales aside); the
    reference's formula takes 8 d^2 a mLSTM and 5 d^2 a sLSTM block:
    the two differ by exactly the terms in ``ArchConfig.param_count``'s
    docstring."""
    for cfg, jcfg in ((T_ARCHS[ARCH], J_ARCHS[ARCH]),
                      (T_ARCHS[ARCH].reduced(), J_ARCHS[ARCH].reduced())):
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        g, m_per = X.xlstm_groups(cfg)
        f = X.slstm_ffn_width(d)
        gap = (g * m_per * (-2 * d * d + 2 * H * d + 2 * H)
               + g * (-d * d + 4 * H * hd * hd + 4 * d + 3 * d * f))
        assert cfg.param_count() - jcfg.param_count() == gap
        assert cfg.active_param_count() == cfg.param_count()
        assert jcfg.active_param_count() == jcfg.param_count()
    _, _, tm, tp = built(ARCH)

    def leaves(t, name=None):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, k)
            else:
                yield k, v

    assert sum(v.numel() for k, v in leaves(tp)
               if k not in ("ln", "ln2", "ln_f")) == tm.cfg.param_count()
    assert T_ARCHS[ARCH].param_count() == 1_562_542_368


def test_config_copied_field_for_field():
    mine, ref = T_ARCHS[ARCH], J_ARCHS[ARCH]
    for f in dataclasses.fields(mine):
        if f.name not in ("attention_impl", "quantize"):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    red, jred = mine.reduced(), ref.reduced()
    for f in ("n_layers", "slstm_every", "ssm_chunk", "d_model", "n_heads",
              "head_dim", "vocab"):
        assert getattr(red, f) == getattr(jred, f), f


# ---------------------------------------------------------------------------
# engine level: each stream against the JAX engine


def test_continuous_batching_matches_serial_greedy():
    """More requests than slots, mixed lengths and budgets: the port
    engine's tokens equal decoding each request alone and the JAX
    engine's, with its counts."""
    _, _, tm, tp = built(ARCH)
    spec = _serving_stream(tm.cfg.vocab)
    kw = dict(KW, page_size=None)
    want, _, stats, _ = jax_run(ARCH, "serial", spec, **kw)
    got, _, eng, reqs = port_run(ARCH, spec, **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)
    for r in reqs:
        assert list(map(int, r.tokens)) == _serial_greedy(
            tm, tp, r.prompt, r.max_new_tokens), r.rid


def test_open_loop_matches_serve():
    """submit() + step() == serve(): the same tokens and counts."""
    _, _, tm, tp = built(ARCH)
    spec = _serving_stream(tm.cfg.vocab)
    closed = ServingEngine(tm, tp, **KW)
    creqs = requests(Request, spec)
    closed.serve(creqs)
    got, _, opened, _ = port_run(ARCH, spec, **KW)
    assert_tokens(got, [r.tokens for r in creqs])
    assert opened.stats == closed.stats
    want, _, _, _ = jax_run(ARCH, "serial", spec, **dict(KW, page_size=None))
    assert_tokens(got, want)


def test_paged_matches_contiguous_bit_identical():
    """A page size is inert for the attention-free family: the engine
    serves contiguously either way, with equal tokens and counts, both
    the JAX engine's."""
    _, _, tm, _ = built(ARCH)
    spec = mixed_stream(tm.cfg.vocab)
    cont, _, ce, _ = port_run(ARCH, spec, **dict(KW, page_size=None))
    paged, _, pe, _ = port_run(ARCH, spec, **dict(KW, page_size=8))
    assert_tokens(paged, cont)
    for key in ("prefill_traces", "prefill_dispatches",
                "decode_dispatches", "admitted"):
        assert ce.stats[key] == pe.stats[key], key
    assert not pe._paged and not pe._all_paged
    want, _, stats, _ = jax_run(ARCH, "mixed-paged", spec,
                                **dict(KW, page_size=8))
    assert_tokens(paged, want)
    assert_counts(pe, stats)


def test_attention_free_family_ignores_paging():
    """The reference's test: no KV to page, so the engine falls back to
    the contiguous (pure-state) path with no allocator, and serves the
    serial greedy tokens; the executor's default page size of 16 serves
    it too."""
    _, _, tm, tp = built(ARCH)
    eng = ServingEngine(tm, tp, max_batch=2, max_len=32, decode_block=4,
                        min_bucket=4, page_size=8)
    assert not eng._paged and eng._alloc is None
    assert eng.pages_per_slot == eng.n_pages == 0
    r = Request(rid=0, prompt=np.arange(6, dtype=np.int32) % tm.cfg.vocab,
                max_new_tokens=3)
    eng.serve([r])
    assert list(map(int, r.tokens)) == _serial_greedy(tm, tp, r.prompt, 3)
    eng16 = ServingEngine(tm, tp, max_batch=2, max_len=32, page_size=16)
    r16 = Request(rid=0, prompt=r.prompt.copy(), max_new_tokens=3)
    eng16.serve([r16])
    assert not eng16._paged
    np.testing.assert_array_equal(r16.tokens, r.tokens)


def test_chunked_prefill_via_empty_state():
    """The reference's ``test_xlstm_chunked_prefill_via_empty_state``:
    prompts past the threshold teacher-force through the decode loop from
    the -1e30 empty state and match boundary prefill exactly; the JAX
    engine's tokens and counts."""
    _, _, tm, _ = built(ARCH)
    rng = np.random.default_rng(7)
    spec = [(rng.integers(0, tm.cfg.vocab, size=p).astype(np.int32), 3)
            for p in (5, 20, 31, 6)]
    kw = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4)
    base, _, _, _ = port_run(ARCH, spec, **kw)
    got, _, eng, _ = port_run(ARCH, spec, chunk_threshold=8, **kw)
    assert eng.chunk_threshold == 8
    assert eng.stats["chunk_admits"] == 2
    assert_tokens(got, base)
    want, _, stats, _ = jax_run(ARCH, "chunked", spec, chunk_threshold=8,
                                **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)


@pytest.mark.parametrize("page_size", [None, 8])
def test_inseg_matches_boundary_bit_identical(page_size):
    """The staging ring refills freed slots inside the step, resetting the
    refilled slots' state rows to the -1e30 empty state there: the tokens
    equal boundary-only admission's and the JAX engine's, with its
    counts (the page size is inert)."""
    _, _, tm, _ = built(ARCH)
    spec = _inseg_stream(tm.cfg.vocab)
    kw = dict(max_batch=2, max_len=64, decode_block=8, min_bucket=4,
              page_size=page_size)
    base, _, be, _ = port_run(ARCH, spec, stage_slots=0, **kw)
    got, _, eng, _ = port_run(ARCH, spec, stage_slots=4, **kw)
    assert be.stats["inseg_admissions"] == 0
    assert eng.stats["inseg_admissions"] > 0
    assert_tokens(got, base)
    assert eng.stats["prefill_dispatches"] < be.stats["prefill_dispatches"]
    assert eng.stats["admitted"] == be.stats["admitted"] == len(spec)
    want, _, stats, _ = jax_run(ARCH, f"inseg-{page_size}", spec,
                                stage_slots=4, **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)


@pytest.mark.parametrize("page_size", [None, 8])
def test_forced_preempt_recovers_bit_identical(page_size):
    """A preempted slot is parked and its prefix replayed from the empty
    state (its state rows reset at the seat): the uninterrupted tokens,
    the JAX engine's tokens and counts."""
    _, _, tm, _ = built(ARCH)
    rng = np.random.default_rng(11)
    spec = [(rng.integers(0, tm.cfg.vocab, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(4, 9)))
            for _ in range(6)]
    kw = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4,
              page_size=page_size)
    ref, _, _, _ = port_run(ARCH, spec, **kw)
    got, _, eng, reqs = port_run(ARCH, spec, hook=_preempt_once, **kw)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["preempt_readmits"] >= 1
    assert any(r.preemptions >= 1 for r in reqs)
    assert_tokens(got, ref)
    want, _, stats, _ = jax_run(ARCH, f"preempt-{page_size}", spec,
                                hook=_preempt_once, **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)


def test_stream_concat_bit_identical():
    """Streamed chunks concatenate to the final tokens, and streaming
    changes no token."""
    _, _, tm, tp = built(ARCH)
    spec = _inseg_stream(tm.cfg.vocab)
    ref, _, _, _ = port_run(ARCH, spec, **KW)
    eng = ServingEngine(tm, tp, stream=True, **KW)
    reqs = requests(Request, spec)
    for r in reqs:
        eng.submit(r)
    chunks = {r.rid: [] for r in reqs}
    while eng.busy:
        eng.step()
        for r, toks, _t in eng.drain_partial_outputs():
            chunks[r.rid].extend(toks)
    assert_tokens([r.tokens for r in reqs], ref)
    for r in reqs:
        assert chunks[r.rid] == [int(x) for x in r.tokens], r.rid


def test_prefix_cache_clamps_off_and_swap_falls_back():
    """The O(1) states cannot be rebuilt from shared pages: the prefix
    cache clamps off, and a forced preemption under ``swap="host"`` falls
    back to recompute (``swap_fallbacks``) with the uninterrupted tokens
    and the JAX engine's tokens and counts."""
    _, _, tm, _ = built(ARCH)
    rng = np.random.default_rng(3)
    spec = [(rng.integers(0, tm.cfg.vocab, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(6, 13)))
            for _ in range(6)]

    def preempt_after_two(eng, n):
        if n == 1:
            live = [s for s in range(eng.max_batch)
                    if eng._slot_req[s] is not None]
            eng.preempt(live[0])

    kw = dict(max_batch=2, max_len=48, decode_block=4, min_bucket=4,
              page_size=8)
    ref, _, _, _ = port_run(ARCH, spec, **kw)
    got, _, eng, _ = port_run(ARCH, spec, hook=preempt_after_two,
                              swap="host", prefix_cache=True, **kw)
    assert eng._prefix is None
    assert eng.stats["swap_fallbacks"] >= 1
    assert eng.stats["swap_out"] == 0 and eng._swap_live_bytes == 0
    assert_tokens(got, ref)
    want, _, stats, _ = jax_run(ARCH, "swap", spec, hook=preempt_after_two,
                                swap="host", **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)


# ---------------------------------------------------------------------------
# port-only: the -1e30 rows at a seat, a refill and a capture's warm-up


def _empty_rows(eng):
    return {n: row[0] for n, row in eng._reset_rows.items()}


def test_seat_writes_empty_rows_and_warm_steps_restore_state():
    """Every leaf is a reset row; a seat writes the slot's rows to the
    empty state (-1e30, 1e-6, zeros) and no other slot's; the warm-up
    steps of a capture leave every state row as it was."""
    _, _, tm, tp = built(ARCH)
    eng = ServingEngine(tm, tp, **dict(KW, page_size=8))
    assert set(eng._reset_rows) == set(LEAVES)
    for name in LEAVES:
        eng._cache[name].normal_()
    before = {n: eng._cache[n].clone() for n in LEAVES}
    eng._warm_steps()
    for n, t in before.items():
        assert torch.equal(eng._cache[n], t), n
    eng._seat_prefix(1, np.arange(5, dtype=np.int32), 3)
    empty = _empty_rows(eng)
    for n, t in before.items():
        leaf = eng._cache[n]
        assert torch.equal(leaf[:, 1], empty[n]), n
        assert torch.equal(leaf[:, 0], t[:, 0])
        assert torch.equal(leaf[:, 2], t[:, 2])
    assert float(eng._cache["mm"][:, 1].max()) == float(np.float32(-1e30))


def test_step_body_refill_writes_empty_rows():
    """A slot that finishes inside the step body and takes the next ring
    entry there (the captured graph's path) ends the step with the empty
    state's rows; a slot the ring does not refill keeps its advanced
    state."""
    _, _, tm, tp = built(ARCH)
    eng = ServingEngine(tm, tp, **dict(KW, stage_slots=2))
    r0 = Request(rid=0, prompt=np.array([4], np.int32), max_new_tokens=1)
    eng._seat_prefix(0, r0.prompt, 1)            # finishes this step
    eng._seat_prefix(1, np.array([5, 6, 7], np.int32), 4)
    nxt = Request(rid=1, prompt=np.array([9, 8, 7], np.int32),
                  max_new_tokens=2)
    eng._staged.append((nxt, ("stage", 0), None))
    eng._ring_stale = True
    eng._sync_ring()
    for name in LEAVES:
        eng._cache[name].normal_()
    with torch.no_grad():
        eng._step_body()
    empty = _empty_rows(eng)
    assert int(eng._comp_adm[0]) == 1 and int(eng._head) == 1
    for n in LEAVES:
        assert torch.equal(eng._cache[n][:, 0], empty[n]), n
    assert not torch.equal(eng._cache["mm"][:, 1], empty["mm"])
