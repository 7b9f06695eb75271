"""The hybrid family (zamba2-1.2b: Mamba2 SSD layers and one shared
attention block) in the port against the JAX package, reduced size, f32,
on the CPU.

Model level: ``prefill_zamba``/``decode_zamba`` logits and every cache leaf
(the ssm and conv states, the shared block's k/v) against ``repro``'s on
converted weights, paged (through a block table) and contiguous; the
reference's prefill/decode smoke case; ``param_count`` against the
initialised tree and the reference's formula.

Engine level, mirroring the zamba2 cases of the reference's
``test_serving_engine.py``, ``test_engine_open_loop.py``,
``test_paged_engine.py`` (both parametrisations), ``test_inseg_admission.py``,
``test_preemption.py``, ``test_streaming.py``,
``test_prefix_cache.py::test_hybrid_family_clamps_prefix_cache_off`` and
``test_swap.py``: each stream is served once by the JAX engine (memoized
per module, ``test_torch_layout.jax_run``) and the port engine must give
its tokens and counts, beside the reference's own checks (serial greedy,
paged == contiguous, streamed chunks). Port-only: the per-slot state rows
are reset by a seat and by the step body's refill, and the capture's
warm-up steps leave them as they were.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import kvcache as JKV
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.models import kvcache as KV
from repro_torch.models import ssm as SSM
from repro_torch.serving.engine import Request, ServingEngine
from test_torch_layout import (assert_counts, assert_tokens, built, drive,
                               jax_run, mixed_stream, port_run, requests)

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
# f32 sums taken in another order by two frameworks; the SSD state sums
# many terms, so it is held relative to its size
TOL = dict(rtol=2e-4, atol=2e-4)
KW = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _prompts(vocab, lens, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, vocab, size=n)
    return toks


# ---------------------------------------------------------------------------
# model level


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_decode_logits_and_cache_match_repro(paged):
    """Prefill of right-padded prompts (the dt mask and the conv tail at
    the last valid inputs), then three decode steps, paged through an
    identity block table or contiguous: logits and every cache leaf
    equal ``repro``'s within f32 tolerance."""
    jm, jp, tm, tp = built(ARCH)
    cfg = tm.cfg
    B, S, L, ps = 2, 16, 32, 8
    lens = np.array([16, 11], np.int32)
    toks = _prompts(cfg.vocab, lens, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "length": jnp.asarray(lens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "length": torch.from_numpy(lens)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for name in ("ssm", "conv", "k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   err_msg=name, **TOL)
    # the decode cache: k/v padded to L (contiguous) or in pools of ps
    jcache, tcache = {}, {}
    for name in ("ssm", "conv"):
        jcache[name] = jc[name]
        tcache[name] = tc[name].clone()
    P = L // ps
    for name in ("k", "v"):
        full = np.zeros(np.asarray(jc[name]).shape[:2] + (L,)
                        + np.asarray(jc[name]).shape[3:], np.float32)
        full[:, :, :S] = np.asarray(jc[name])
        if paged:
            g = full.shape[0]
            pool = full.reshape((g, B * P, ps) + full.shape[3:])
            jcache[name] = jnp.asarray(pool)
            tcache[name] = torch.from_numpy(pool.copy())
        else:
            jcache[name] = jnp.asarray(full)
            tcache[name] = torch.from_numpy(full.copy())
    if paged:
        bt = np.arange(B * P, dtype=np.int32).reshape(B, P)
        jcache["bt"] = jnp.asarray(bt)
        tcache["bt"] = torch.from_numpy(bt)
    rng = np.random.default_rng(1)
    pos = lens.copy()
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok),
                               torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
        for name in ("ssm", "conv", "k", "v"):
            np.testing.assert_allclose(_np(tcache[name]),
                                       np.asarray(jcache[name]),
                                       err_msg=name, **TOL)
        pos = pos + 1


def test_prefill_decode_smoke():
    """The zamba2 case of the reference's ``test_prefill_decode_smoke``:
    prefill then a decode step from the returned cache, finite logits of
    the vocabulary's width and cache leaves of ``cache_shapes``' shapes."""
    _, _, tm, tp = built(ARCH)
    cfg = tm.cfg
    B, S = 2, 16
    toks = torch.from_numpy(_prompts(cfg.vocab, [S, S], S)).long()
    logits, cache = tm.prefill(tp, {"tokens": toks})
    assert logits.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    shapes = tm.cache_shapes(B, S)
    for name, (sh, dt) in shapes.items():
        assert tuple(cache[name].shape) == sh and cache[name].dtype == dt
    big = {n: torch.zeros(sh, dtype=dt)
           for n, (sh, dt) in tm.cache_shapes(B, S + 4).items()}
    for n in ("ssm", "conv"):
        big[n].copy_(cache[n])
    for n in ("k", "v"):
        big[n][:, :, :S] = cache[n]
    logits2, _ = tm.decode(tp, big, toks[:, -1:],
                           torch.full((B,), S, dtype=torch.int32))
    assert logits2.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits2).all())
    empty = tm.empty_state(B, S)
    assert all(not bool(t.any()) for t in empty.values())
    assert tm.decode_window is None


def test_param_count_against_the_tree_and_repro():
    """The port counts the initialised tree (norm scales aside); the
    reference's formula sizes ``w_dt`` by the attention heads and leaves
    out the convolutions, ``A_log``, ``D`` and ``dt_bias``: the two
    differ by exactly that, per Mamba layer."""
    for cfg, jcfg in ((T_ARCHS[ARCH], J_ARCHS[ARCH]),
                      (T_ARCHS[ARCH].reduced(), J_ARCHS[ARCH].reduced())):
        d = cfg.d_model
        di, h, _, _ = SSM.mamba_dims(cfg)
        n2 = 2 * cfg.ssm_state
        gap = cfg.n_layers * (d * (h - cfg.n_heads) + 5 * (di + n2) + 3 * h)
        assert cfg.param_count() - jcfg.param_count() == gap
        assert cfg.active_param_count() == cfg.param_count()
    _, _, tm, tp = built(ARCH)

    def leaves(t, name=None):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, k)
            else:
                yield k, v

    n = sum(v.numel() for k, v in leaves(tp)
            if k not in ("ln1", "ln2", "ln_f", "norm"))
    assert n == tm.cfg.param_count()
    assert T_ARCHS[ARCH].param_count() == 1_170_234_240


def test_config_copied_field_for_field():
    mine, ref = T_ARCHS[ARCH], J_ARCHS[ARCH]
    for f in dataclasses.fields(mine):
        if f.name not in ("attention_impl", "quantize"):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    red, jred = mine.reduced(), ref.reduced()
    for f in ("n_layers", "ssm_state", "ssm_chunk", "shared_attn_every",
              "d_model", "vocab"):
        assert getattr(red, f) == getattr(jred, f), f


def test_state_row_helpers_match_repro():
    """``reset_slot_rows`` (a masked write of fixed shape, in place) and
    the host copies ``gather_state_rows``/``scatter_state_rows`` against
    ``repro.models.kvcache``."""
    rng = np.random.default_rng(0)
    leaf = rng.standard_normal((3, 4, 2, 5)).astype(np.float32)
    empty = rng.standard_normal((1, 3, 2, 5)).astype(np.float32)
    take = np.array([True, False, True, False])
    want = JKV.reset_slot_rows(jnp.asarray(leaf), 1, jnp.asarray(take),
                               jnp.asarray(empty))
    got = torch.from_numpy(leaf.copy())
    out = KV.reset_slot_rows(got, 1, torch.from_numpy(take),
                             torch.from_numpy(empty))
    assert out is got
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    row = KV.gather_state_rows(got, 1, 2)
    np.testing.assert_array_equal(_np(row),
                                  JKV.gather_state_rows(want, 1, 2))
    other = torch.zeros_like(got)
    KV.scatter_state_rows(other, 1, 3, row)
    np.testing.assert_array_equal(
        _np(other), np.asarray(JKV.scatter_state_rows(
            jnp.zeros_like(want), 1, 3, np.asarray(row))))


# ---------------------------------------------------------------------------
# engine level: each stream against the JAX engine


def _serial_greedy(tm, tp, prompt, n):
    """The port model's greedy tokens for one prompt, prefilling the
    growing sequence each step (the reference's ``_serial_greedy`` rolls
    ``forward`` the same way)."""
    seq = list(map(int, prompt))
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits, _ = tm.prefill(tp, {"tokens": torch.tensor([seq])})
            out.append(int(torch.argmax(logits[0, -1])))
            seq.append(out[-1])
    return out


def _serving_stream(vocab, n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 12))
                          ).astype(np.int32), int(rng.integers(1, 6)))
            for _ in range(n)]


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
    got, _, opened, reqs = port_run(ARCH, spec, **KW)
    assert_tokens(got, [r.tokens for r in creqs])
    assert opened.stats == closed.stats
    want, _, stats, _ = jax_run(ARCH, "serial", spec,
                                **dict(KW, page_size=None))
    assert_tokens(got, want)


def test_paged_matches_contiguous_bit_identical():
    """The shared block's k/v paged (the ssm and conv states stay per
    slot) against the contiguous layout: equal tokens and counts, and
    both equal the JAX engine's."""
    _, _, tm, _ = built(ARCH)
    spec = mixed_stream(tm.cfg.vocab)
    cont, _, ce, _ = port_run(ARCH, spec, **dict(KW, page_size=None))
    paged, _, pe, _ = port_run(ARCH, spec, **dict(KW, page_size=8))
    assert_tokens(paged, cont)
    for key in ("prefill_traces", "prefill_dispatches",
                "decode_dispatches", "admitted"):
        assert ce.stats[key] == pe.stats[key], key
    assert pe._paged and pe._alloc.n_free == pe.n_pages
    assert not pe._all_paged
    want, _, stats, _ = jax_run(ARCH, "mixed-paged", spec,
                                **dict(KW, page_size=8))
    assert_tokens(paged, want)
    assert_counts(pe, stats)


def test_chunked_prefill_matches_serial_greedy():
    """Prompts past the threshold are seated (their state rows reset) and
    fed through the decode steps: exact greedy tokens, the JAX engine's
    tokens and chunked admits."""
    _, _, tm, tp = built(ARCH)
    spec = mixed_stream(tm.cfg.vocab)
    kw = dict(KW, page_size=8, chunk_threshold=12)
    want, _, stats, _ = jax_run(ARCH, "chunked", spec, **kw)
    got, _, eng, reqs = port_run(ARCH, spec, **kw)
    n_chunked = sum(len(p) > 12 for p, _ in spec)
    assert eng.stats["chunk_admits"] == n_chunked > 0
    assert_tokens(got, want)
    assert_counts(eng, stats)
    for r in reqs:
        assert list(map(int, r.tokens)) == _serial_greedy(
            tm, tp, r.prompt, r.max_new_tokens), r.rid


def _inseg_stream(vocab, n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(1, 6)))
            for _ in range(n)]


@pytest.mark.parametrize("page_size", [None, 8])
def test_inseg_matches_boundary_bit_identical(page_size):
    """The staging ring refills freed slots inside the step, resetting the
    refilled slots' state rows there: the tokens equal boundary-only
    admission's and the JAX engine's, with its counts."""
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
    want, _, stats, _ = jax_run(ARCH, f"inseg-{page_size}", spec,
                                stage_slots=4, **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)
    if eng._paged:
        assert eng._alloc.n_free == eng.n_pages


def _preempt_once(eng, n):
    if n == 0:
        live = [s for s in range(eng.max_batch)
                if eng._slot_req[s] is not None]
        eng.preempt(live[0])


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
    if eng._paged:
        assert eng._alloc.n_free == eng.n_pages
        assert eng._alloc.committed == 0


@pytest.mark.parametrize("page_size", [None, 8])
def test_stream_concat_bit_identical(page_size):
    """Streamed chunks concatenate to the final tokens, and streaming
    changes no token."""
    _, _, tm, tp = built(ARCH)
    spec = _inseg_stream(tm.cfg.vocab)
    kw = dict(KW, page_size=page_size)
    ref, _, _, _ = port_run(ARCH, spec, **kw)
    eng = ServingEngine(tm, tp, stream=True, **kw)
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


def test_hybrid_family_clamps_prefix_cache_off():
    """zamba2's O(1) state leaves cannot be rebuilt from shared pages: the
    prefix cache clamps off and the tokens stay the JAX engine's."""
    _, _, tm, _ = built(ARCH)
    spec = mixed_stream(tm.cfg.vocab, seed=5)
    kw = dict(max_batch=4, max_len=64, decode_block=8, page_size=8,
              chunk_threshold=12)
    got, _, eng, _ = port_run(ARCH, spec, prefix_cache=True, **kw)
    assert eng._prefix is None
    assert eng.stats["prefix_hits"] == 0
    want, _, _, _ = jax_run(ARCH, "prefix-off", spec, **kw)
    assert_tokens(got, want)


def test_swap_recurrent_family_falls_back():
    """A page capture alone cannot restore the per-slot state: host swap
    falls back to recompute (``swap_fallbacks``) and stays exact."""
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
                              swap="host", **kw)
    assert eng.stats["swap_fallbacks"] >= 1
    assert eng.stats["swap_out"] == 0 and eng._swap_live_bytes == 0
    assert_tokens(got, ref)
    want, _, stats, _ = jax_run(ARCH, "swap", spec, hook=preempt_after_two,
                                swap="host", **kw)
    assert_tokens(got, want)
    assert_counts(eng, stats)


# ---------------------------------------------------------------------------
# port-only: the state rows around a seat, a refill and a capture's warm-up


def test_seat_resets_and_warm_steps_restore_state_rows():
    """A seat zeroes the slot's ssm and conv rows and no other slot's; the
    warm-up steps a capture runs leave every state row as it was (they
    advance every slot's state)."""
    _, _, tm, tp = built(ARCH)
    eng = ServingEngine(tm, tp, **dict(KW, page_size=8))
    for name in ("ssm", "conv"):
        eng._cache[name].normal_()
    before = {n: eng._cache[n].clone() for n in ("ssm", "conv")}
    eng._warm_steps()
    for n, t in before.items():
        assert torch.equal(eng._cache[n], t), n
    eng._seat_prefix(1, np.arange(5, dtype=np.int32), 3)
    for n, t in before.items():
        leaf = eng._cache[n]
        assert not leaf[:, 1].any(), n
        assert torch.equal(leaf[:, 0], t[:, 0])
        assert torch.equal(leaf[:, 2], t[:, 2])


def test_step_body_refill_resets_state_rows():
    """A slot the ring refills inside the step has its state rows reset
    there (the captured graph's path), the others' advance."""
    _, _, tm, tp = built(ARCH)
    eng = ServingEngine(tm, tp, **dict(KW, page_size=8, stage_slots=2))
    a = Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=1)
    b = Request(rid=1, prompt=np.arange(6, dtype=np.int32) + 3,
                max_new_tokens=5)
    c = Request(rid=2, prompt=np.arange(5, dtype=np.int32) + 7,
                max_new_tokens=2)
    d = Request(rid=3, prompt=np.arange(7, dtype=np.int32) + 1,
                max_new_tokens=2)
    order = drive(eng, [a, b, c, d])
    assert eng.stats["inseg_admissions"] >= 1
    jm, jp, _, _ = built(ARCH)
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    jeng = JEngine(jm, jp, **dict(KW, page_size=8, stage_slots=2))
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt.copy(),
                      max_new_tokens=r.max_new_tokens) for r in (a, b, c, d)]
    assert drive(jeng, jreqs) == order
    assert_tokens([r.tokens for r in (a, b, c, d)],
                  [np.asarray(r.tokens) for r in jreqs])
    assert eng.stats["inseg_admissions"] == jeng.stats["inseg_admissions"]
