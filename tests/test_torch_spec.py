"""Speculative decoding (draft-then-verify) in the port against the JAX
package, reduced size, f32, on the CPU.

Mirrors the reference's ``tests/test_spec_decode.py``: with
``speculate=(draft_model, draft_params)`` the token stream is plain greedy
decode's, whatever the draft proposes. Every mirrored case serves the same
stream through the port's plain and speculating engines; where the JAX
engine is served too (the bit-identity matrix, the fuzz's first trials)
the port gives its tokens and its ``spec_rounds``, ``spec_proposed``,
``spec_accepted`` and ``decode_steps`` on weights carried across with
``convert.py``. The matrix is the reference's: ``llama3.2-1b`` (dense,
one ``decode_window`` verify), ``xlstm-1.3b`` (ssm: the sequential verify
and the replay re-seat; a page size is inert) and ``zamba2-1.2b`` (hybrid,
the same verify and re-seat) x page size None and 8. The reference's
Pallas case is the port's ``attention_impl="cuda"``, refused by name
before anything launches (no CUDA needed).

Below the engine: ``decode_window_dense`` logits against ``repro``'s
(paged and contiguous, f32 ``allclose``), a one-token window equal to
``decode_dense`` bit for bit, and ``kvcache.paged_update_window`` against
``repro.models.kvcache`` with sentinel rows dropped, on both of its drop
paths.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
from repro.models import kvcache as JKV
from repro.models.quantize import quantize_params_dense as j_quantize
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.registry import ARCHS as T_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model as t_build
from repro_torch.models import kvcache as KV
from repro_torch.serving.engine import Request, ServingEngine

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

# f32 sums taken in another order by two frameworks
TOL = dict(rtol=2e-5, atol=2e-5)
SPEC_COUNTS = ("spec_rounds", "spec_proposed", "spec_accepted",
               "decode_steps", "decode_dispatches", "busy_slot_steps")


@functools.lru_cache(maxsize=None)
def _build(arch, quantize="none", seed=0):
    """(JAX model, JAX params, port model, port params) of a reduced
    config; int8 variants quantize the fp tree of the same seed."""
    jcfg, tcfg = J_ARCHS[arch].reduced(), T_ARCHS[arch].reduced()
    if quantize == "none":
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(seed))
    else:
        jp = j_quantize(_build(arch, seed=seed)[1])
        jcfg = dataclasses.replace(jcfg, quantize=quantize)
        tcfg = dataclasses.replace(tcfg, quantize=quantize)
        jm = j_build(jcfg)
    return jm, jp, t_build(tcfg, device="cpu"), params_from_jax(jp, "cpu")


def _stream(cls, vocab, n=6, seed=11, max_new=(4, 10)):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, vocab, size=int(rng.integers(3, 10))
                                    ).astype(np.int32),
                max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _tokens(reqs):
    return [list(map(int, r.tokens)) for r in reqs]


def _serve(cls, model, params, reqs, **kw):
    eng = cls(model, params, **dict(dict(max_batch=3, max_len=48,
                                         decode_block=4, min_bucket=4), **kw))
    eng.warmup(prompt_lens=[len(r.prompt) for r in reqs])
    eng.serve(reqs)
    return eng


def _pair(arch, draft, stream_kw, spec_k, quantize="none", **kw):
    """The port's plain and speculating serves of one stream, and the JAX
    engine's speculating serve: (plain tokens, port engine, port tokens,
    JAX engine, JAX tokens)."""
    jm, jp, tm, tp = _build(arch, quantize)
    jdm, jdp, tdm, tdp = draft
    vocab = tm.cfg.vocab
    plain = _stream(Request, vocab, **stream_kw)
    _serve(ServingEngine, tm, tp, plain, **kw)
    spec = _stream(Request, vocab, **stream_kw)
    eng = _serve(ServingEngine, tm, tp, spec, speculate=(tdm, tdp),
                 spec_k=spec_k, **kw)
    # the JAX serve, shared by cases that give it the same inputs: a page
    # size is inert for the attention-free ssm family
    paged = tm.cfg.family != "ssm"
    key = (arch, quantize, id(draft), tuple(sorted(stream_kw.items())),
           spec_k, tuple(sorted((k, v) for k, v in kw.items()
                                if paged or k != "page_size")))
    if key not in _JAX_SERVES:
        jspec = _stream(JRequest, vocab, **stream_kw)
        jeng = _serve(JEngine, jm, jp, jspec, speculate=(jdm, jdp),
                      spec_k=spec_k, **kw)
        _JAX_SERVES[key] = jeng, _tokens(jspec)
    jeng, jtokens = _JAX_SERVES[key]
    return _tokens(plain), eng, _tokens(spec), jeng, jtokens


_JAX_SERVES: dict = {}


def _assert_jax_counts(eng, jeng):
    for key in SPEC_COUNTS:
        assert eng.stats[key] == jeng.stats[key], (key, eng.stats[key],
                                                  jeng.stats[key])


# ---------------------------------------------------------------------------
# bit identity across families, layouts and acceptance regimes


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
@pytest.mark.parametrize("page_size", [None, 8])
def test_spec_matches_plain_greedy(arch, page_size):
    """Speculating == plain, token for token, and == the JAX engine's
    tokens and spec counts. The dense target drafts with its own int8
    variant (whole windows accepted); the hybrid and ssm targets with an
    unrelated dense model (near-zero acceptance: the sequential verify and
    the replay run every round)."""
    draft = (_build(arch, "int8") if arch == "llama3.2-1b"
             else _build("llama3.2-1b"))
    assert draft[2].cfg.vocab == _build(arch)[2].cfg.vocab
    plain, eng, spec, jeng, jspec = _pair(arch, draft, {}, 4,
                                          page_size=page_size)
    assert spec == plain
    assert spec == jspec
    _assert_jax_counts(eng, jeng)
    assert eng.stats["spec_rounds"] >= 1
    assert 0.0 <= eng.occupancy["spec_accept_rate"] <= 1.0
    assert eng.occupancy["spec_accept_rate"] == \
        jeng.occupancy["spec_accept_rate"]
    if eng._paged:
        assert eng._alloc.n_free == eng.n_pages


def test_spec_self_draft_high_accept():
    """The target as its own draft accepts nearly everything (the full
    window path) and the stream is still plain decode's."""
    _, _, tm, tp = _build("llama3.2-1b")
    kw = dict(seed=3, max_new=(10, 14))
    plain = _stream(Request, tm.cfg.vocab, **kw)
    _serve(ServingEngine, tm, tp, plain)
    spec = _stream(Request, tm.cfg.vocab, **kw)
    eng = _serve(ServingEngine, tm, tp, spec, speculate=(tm, tp), spec_k=3)
    assert _tokens(plain) == _tokens(spec)
    assert eng.stats["spec_proposed"] > 0
    assert eng.stats["spec_accepted"] >= 0.6 * eng.stats["spec_proposed"]


def test_spec_int8_target_bit_identical():
    """A quantized target speculates too: int8 speculating == int8 plain,
    and == the JAX engine's int8 target."""
    plain, eng, spec, jeng, jspec = _pair(
        "llama3.2-1b", _build("llama3.2-1b", "int8"), dict(seed=5), 3,
        quantize="int8")
    assert eng.model.cfg.quantize == "int8"
    assert spec == plain
    assert spec == jspec
    _assert_jax_counts(eng, jeng)


def test_spec_mismatch_rollback_page_hygiene():
    """An independent draft is rejected nearly every round: the paged
    engine rolls back continuously, matches plain decode and returns every
    page it grew for the windows."""
    indep = _build("llama3.2-1b", seed=99)
    plain, eng, spec, jeng, jspec = _pair(
        "llama3.2-1b", indep, dict(seed=7, max_new=(10, 14)), 4,
        page_size=8)
    assert spec == plain == jspec
    _assert_jax_counts(eng, jeng)
    assert eng.stats["spec_rounds"] >= 1
    assert eng._alloc.n_free == eng.n_pages
    assert eng._alloc.committed == 0


def test_preempt_mid_speculation_recovers():
    """Preempting a slot between rounds parks it; its replay finishes with
    the uninterrupted speculating serve's tokens, and the freed slot's
    draft rows resync rather than mislead later occupants."""
    _, _, tm, tp = _build("llama3.2-1b")
    _, _, dm, dp = _build("llama3.2-1b", "int8")
    kw = dict(max_batch=2, max_len=48, decode_block=4, min_bucket=4,
              page_size=8, speculate=(dm, dp), spec_k=3)
    ref = _stream(Request, tm.cfg.vocab, n=5, seed=13, max_new=(6, 12))
    ref_eng = ServingEngine(tm, tp, **kw)
    ref_eng.warmup(prompt_lens=[len(r.prompt) for r in ref])
    ref_eng.serve(ref)
    eng = ServingEngine(tm, tp, **kw)
    got = _stream(Request, tm.cfg.vocab, n=5, seed=13, max_new=(6, 12))
    eng.warmup(prompt_lens=[len(r.prompt) for r in got])
    for r in got:
        eng.submit(r)
    eng.step()
    eng.step()
    assert eng.stats["spec_rounds"] >= 1
    live = [s for s in range(eng.max_batch) if eng._slot_req[s] is not None]
    assert live
    eng.preempt(live[0])
    while eng.busy:
        eng.step()
    eng.drain_completions()
    assert eng.stats["preemptions"] >= 1
    assert _tokens(ref) == _tokens(got)
    assert eng._alloc.n_free == eng.n_pages


def test_spec_seeded_fuzz_acceptance_lengths():
    """Draft quality x spec_k x stream shape, seeded: whatever prefix the
    verify accepts (0..k), the stream is plain decode's; the first three
    trials also give the JAX engine's tokens and spec counts."""
    _, _, tm, tp = _build("llama3.2-1b")
    drafts = {"self": _build("llama3.2-1b"),
              "int8": _build("llama3.2-1b", "int8"),
              "indep": _build("llama3.2-1b", seed=42)}
    rng = np.random.default_rng(0)
    for trial in range(6):
        name = ["self", "int8", "indep"][trial % 3]
        k = int(rng.integers(1, 7))
        seed = int(rng.integers(1 << 16))
        page = [None, 8][trial % 2]
        msg = f"trial={trial} draft={name} k={k} seed={seed} page={page}"
        if trial < 3:
            plain, eng, spec, jeng, jspec = _pair(
                "llama3.2-1b", drafts[name], dict(n=4, seed=seed), k,
                page_size=page)
            assert spec == jspec, msg
            _assert_jax_counts(eng, jeng)
        else:
            plain = _stream(Request, tm.cfg.vocab, n=4, seed=seed)
            _serve(ServingEngine, tm, tp, plain, page_size=page)
            plain = _tokens(plain)
            got = _stream(Request, tm.cfg.vocab, n=4, seed=seed)
            _serve(ServingEngine, tm, tp, got, page_size=page,
                   speculate=drafts[name][2:], spec_k=k)
            spec = _tokens(got)
        assert spec == plain, msg


# ---------------------------------------------------------------------------
# constructor validation (no decoding)


def test_spec_engine_validation():
    _, _, tm, tp = _build("llama3.2-1b")
    _, _, dm, dp = _build("llama3.2-1b", seed=1)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tm, tp, max_batch=2, speculate=(dm, dp), spec_k=0)
    bad_vocab = t_build(dataclasses.replace(T_ARCHS["llama3.2-1b"].reduced(),
                                            vocab=tm.cfg.vocab + 7), "cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(tm, tp, max_batch=2, speculate=(bad_vocab, dp))
    # the kernel attention impl (the reference's Pallas case): refused by
    # name before anything launches, so no CUDA is needed to see it
    cuda_model = dataclasses.replace(tm, cfg=dataclasses.replace(
        tm.cfg, attention_impl="cuda"))
    with pytest.raises(ValueError, match="attention_impl='torch'"):
        ServingEngine(cuda_model, tp, max_batch=2, speculate=(dm, dp))
    # a non-dense draft has no batched teacher-forced draft loop
    _, _, hm, hp = _build("zamba2-1.2b")
    assert hm.cfg.vocab == tm.cfg.vocab
    with pytest.raises(ValueError, match="dense"):
        ServingEngine(tm, tp, max_batch=2, speculate=(hm, hp))
    _, _, sm, sp = _build("xlstm-1.3b")
    assert sm.cfg.vocab == tm.cfg.vocab
    with pytest.raises(ValueError, match="dense"):
        ServingEngine(tm, tp, max_batch=2, speculate=(sm, sp))
    # families without the replay path cannot speculate
    wm = t_build(T_ARCHS["whisper-base"].reduced(), "cpu")
    with pytest.raises(ValueError, match="family"):
        ServingEngine(wm, wm.init(0), max_batch=2, speculate=(dm, dp))
    # the speculating target's config: plain attention on the card, the
    # int8 GEMM kept; the CPU config as it is
    cfg = dataclasses.replace(T_ARCHS["llama3.2-1b"], quantize="int8")
    tgt = cfg.for_device("cuda", speculate=True)
    assert (tgt.attention_impl, tgt.quantize) == ("torch", "int8_cuda")
    assert cfg.for_device("cuda").attention_impl == "cuda"
    assert cfg.for_device("cpu", speculate=True) is cfg
    eng = ServingEngine(tm, tp, max_batch=2, stage_slots=4,
                        speculate=(dm, dp))
    assert eng.stage_slots == 0 and eng.spec_k == 4


# ---------------------------------------------------------------------------
# the model: the verify window and its paged write


def _window_inputs(paged, B=3, S=5, L=32, ps=8, seed=0):
    """A prefilled dense cache (contiguous, or pools behind a shuffled
    block table with sentinel entries past each slot's pages) for the JAX
    model and the port, a window of tokens and each slot's position."""
    jm, jp, tm, tp = _build("llama3.2-1b")
    rng = np.random.default_rng(seed)
    lens = np.array([9, 4, 17][:B], np.int32)
    toks = np.zeros((B, 17), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, tm.cfg.vocab, n)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                            "length": jnp.asarray(lens)})
    full = {n: np.zeros(np.asarray(v).shape[:2] + (L,)
                        + np.asarray(v).shape[3:], np.float32)
            for n, v in jc.items()}
    for n in full:
        full[n][:, :, :17] = np.asarray(jc[n])
    window = rng.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32)
    if not paged:
        return (jm, jp, tm, tp, {n: jnp.asarray(v) for n, v in full.items()},
                {n: torch.from_numpy(v.copy()) for n, v in full.items()},
                window, lens)
    P = L // ps
    n_pages = B * P + 2
    perm = rng.permutation(n_pages)[:B * P].reshape(B, P)
    need = -(-(lens + S) // ps)
    bt = np.where(np.arange(P)[None, :] < need[:, None], perm,
                  n_pages).astype(np.int32)
    jcache, tcache = {"bt": jnp.asarray(bt)}, {"bt": torch.from_numpy(bt)}
    for n, v in full.items():
        Ly = v.shape[0]
        pool = np.zeros((Ly, n_pages, ps) + v.shape[3:], np.float32)
        for b in range(B):
            for j in range(P):
                if bt[b, j] < n_pages:
                    pool[:, bt[b, j]] = v[:, b, j * ps:(j + 1) * ps]
        jcache[n] = jnp.asarray(pool)
        tcache[n] = torch.from_numpy(pool.copy())
    return jm, jp, tm, tp, jcache, tcache, window, lens


@pytest.mark.parametrize("paged", [False, True])
def test_decode_window_matches_repro(paged):
    """``decode_window_dense`` logits and the written cache against
    ``repro``'s, f32: the window's k/v written at pos .. pos + S - 1 (the
    paged write through the block table) and each window token masked to
    its own position."""
    jm, jp, tm, tp, jcache, tcache, window, pos = _window_inputs(paged)
    jl, jc = jm.decode_window(jp, jcache, jnp.asarray(window),
                              jnp.asarray(pos))
    tl, tc = tm.decode_window(tp, tcache, torch.from_numpy(window),
                              torch.from_numpy(pos))
    assert tl.shape == (3, 5, tm.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_window_of_one_is_the_decode_step_bit_for_bit(paged):
    """At S == 1 the window's mask and operations are the decode step's:
    the same logits and cache, bit for bit."""
    _, _, tm, tp, _, cache, window, pos = _window_inputs(paged, S=1)
    other = {n: t.clone() for n, t in cache.items()}
    tok = torch.from_numpy(window)
    wl, _ = tm.decode_window(tp, cache, tok, torch.from_numpy(pos))
    dl, _ = tm.decode(tp, other, tok, torch.from_numpy(pos))
    assert torch.equal(wl, dl)
    for n in cache:
        assert torch.equal(cache[n], other[n]), n


@pytest.mark.parametrize("n_pages", [9, 2])
def test_paged_update_window_matches_repro(n_pages):
    """The window write against ``repro.models.kvcache``: B x S rows
    through the block table, entries at the sentinel dropped (a pool
    larger than the B x S rows takes the spare-row drop a graph can
    capture; a smaller one the mask)."""
    rng = np.random.default_rng(2)
    B, S, ps, K, D, P = 3, 4, 4, 2, 3, 3
    pool = rng.normal(size=(n_pages, ps, K, D)).astype(np.float32)
    k_new = rng.normal(size=(B, S, K, D)).astype(np.float32)
    v_new = rng.normal(size=(B, S, K, D)).astype(np.float32)
    bt = np.full((B, P), n_pages, np.int32)     # slot 2: all sentinel
    bt[0, :2] = [1, 0]
    if n_pages > 2:
        bt[1, :2] = [8, 3]
    pos = np.array([2, 1, 5], np.int32)
    jk, jv = JKV.paged_update_window(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(bt), jnp.asarray(pos))
    tk, tv = torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())
    KV.paged_update_window(tk, tv, torch.from_numpy(k_new),
                           torch.from_numpy(v_new), torch.from_numpy(bt),
                           torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
