"""Prefill as one program per ``(nbatch, bucket)`` key in the port's engine,
against the JAX package's compiled prefill, reduced size, f32, on the CPU.

* Mirrors of the reference's ``test_compile_count_bounded_by_buckets`` and
  ``test_warmup_precompiles_service_shapes``: the port's ``_prefill_fns``
  key set and ``prefill_traces`` equal the JAX engine's on the same
  stream, a repeated stream builds nothing, and a warm engine serves its
  covered buckets without a new program; the tokens are the JAX
  engine's. (On the card each program is a captured graph; here it runs
  the same body, and ``decode_traces`` stays 0.)
* The program's fixed-shape writes: ``kvcache.scatter_page_rows`` (page
  rows past a slot's pages and padding rows sent to a copy of a kept row)
  writes the pool bytes of the masked scatter, and a capture's warm-up
  runs (``_prefill_quiesced``) leave every leaf and the slot state of a
  live engine bit for bit as they were, in both layouts and every family.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.models import build_model as j_build
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

_BUILT = {}


def built(arch="llama3.2-1b"):
    """(JAX model, JAX params, port model, port params), the port's
    weights carried across from the JAX init."""
    if arch not in _BUILT:
        jm = j_build(J_ARCHS[arch].reduced())
        jp = jm.init(jax.random.PRNGKey(0))
        _BUILT[arch] = (jm, jp, t_build(T_ARCHS[arch].reduced(), "cpu"),
                        params_from_jax(jp, device="cpu"))
    return _BUILT[arch]


def engines(**kw):
    jm, jp, tm, tp = built()
    return JEngine(jm, jp, **kw), ServingEngine(tm, tp, **kw)


def stream(cls, plens, max_new, base=0):
    return [cls(rid=base + i, prompt=np.arange(p, dtype=np.int32) % 256,
                max_new_tokens=max_new) for i, p in enumerate(plens)]


def test_compile_count_bounded_by_buckets():
    """<= one program per (bucket_batch, bucket_len) key across mixed-shape
    streams, the same keys and trace count as the JAX engine's."""
    geo = dict(max_batch=4, max_len=64, decode_block=4, min_bucket=4)
    jeng, eng = engines(**geo)
    plens = [3, 5, 8, 9, 16, 2, 11, 4]           # len buckets: {4, 8, 16}
    jreqs, reqs = stream(JRequest, plens, 3), stream(Request, plens, 3)
    jeng.serve(jreqs)
    eng.serve(reqs)
    assert set(eng._prefill_fns) == set(jeng._prefill_fns)
    assert eng.stats["prefill_traces"] == jeng.stats["prefill_traces"] \
        == len(eng._prefill_fns) <= 6, eng.stats
    assert {b for _, b in eng._prefill_fns} == {4, 8, 16}
    assert eng.stats["decode_traces"] == 0          # no graphs on the CPU
    for a, b in zip(jreqs, reqs):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
    # an identical mixed-shape stream must not build anything
    before = dict(eng.stats)
    progs = dict(eng._prefill_fns)
    eng.serve(stream(Request, plens, 3, base=100))
    assert eng.stats["prefill_traces"] == before["prefill_traces"]
    assert eng._prefill_fns == progs


def test_warmup_precompiles_service_shapes():
    """After warmup, serving on covered buckets builds no program; the key
    set after warmup is the JAX engine's, and a second warmup on covered
    lengths is free (the reference's "already compiled; skip")."""
    geo = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4)
    jeng, eng = engines(**geo)
    jeng.warmup(prompt_lens=[5, 12])
    eng.warmup(prompt_lens=[5, 12])
    assert set(eng._prefill_fns) == set(jeng._prefill_fns) == {
        (1, 4), (2, 4), (1, 8), (2, 8), (1, 16), (2, 16)}
    traces = (eng.stats["prefill_traces"], eng.stats["decode_traces"])
    assert traces[0] == jeng.stats["prefill_traces"]
    progs = dict(eng._prefill_fns)
    eng.warmup(prompt_lens=[4, 6, 9, 12])
    assert eng._prefill_fns == progs
    plens = [4, 6, 9, 12]
    jreqs, reqs = stream(JRequest, plens, 2), stream(Request, plens, 2)
    jeng.serve(jreqs)
    out = eng.serve(reqs)
    assert all(r.tokens is not None and len(r.tokens) == 2 for r in out)
    assert (eng.stats["prefill_traces"], eng.stats["decode_traces"]) \
        == traces, eng.stats
    for a, b in zip(jreqs, reqs):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)


def test_warmup_skips_chunked_lengths_and_one_slot_engines():
    """Chunked prompts never prefill, so warmup builds nothing for them; a
    one-slot engine has only nbatch-1 programs."""
    _, eng = engines(max_batch=1, max_len=64, decode_block=4, min_bucket=4,
                     chunk_threshold=8)
    eng.warmup(prompt_lens=[5, 30, 60])
    assert set(eng._prefill_fns) == {(1, 4), (1, 8)}


def test_scatter_page_rows_writes_the_masked_scatter():
    """The fixed-shape pool write against ``scatter_pages`` (which drops
    sentinel page rows on the host): a two-row admit batch padded to four
    rows, one slot with fewer pages than its bucket spans. Duplicates carry
    the kept row's bytes, so every page, free ones included, matches."""
    gen = torch.Generator().manual_seed(0)
    L, S, K, D, ps, n_pages = 2, 16, 2, 4, 4, 12
    nb, n_rows = 4, S // ps
    new = torch.randn((L, nb, S, K, D), generator=gen)
    pool = torch.randn((L, n_pages, ps, K, D), generator=gen)
    page_rows = np.full((nb, n_rows), n_pages, np.int64)
    page_rows[0] = [3, 7, 1, 10]
    page_rows[1, :2] = [0, 5]
    want = pool.clone()
    KV.scatter_pages(want, new, page_rows, 1, 2)
    flat = page_rows.reshape(-1)
    kept = flat < n_pages
    src = torch.from_numpy(np.where(kept, np.arange(flat.size), 0))
    dst = torch.from_numpy(np.where(kept, flat, flat[0]))
    got = pool.clone()
    KV.scatter_page_rows(got, new, src, dst, 1, 2)
    assert torch.equal(got, want)


def _live_engine(arch, **kw):
    """A port engine of ``arch`` mid-serve: three requests seated (two of
    them prefilled in one padded dispatch), decode under way."""
    _, _, tm, tp = built(arch)
    eng = ServingEngine(tm, tp, max_batch=3, max_len=32, decode_block=4,
                        min_bucket=4, **kw)
    rng = np.random.default_rng(4)
    for i, (n, k) in enumerate(((9, 12), (5, 10), (7, 11))):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, 256, size=n).astype(np.int32), max_new_tokens=k))
    eng.step()
    eng.step()
    assert all(r is not None for r in eng._slot_req)
    return eng


@pytest.mark.parametrize("arch,page_size", [
    ("llama3.2-1b", 8), ("llama3.2-1b", None), ("whisper-base", 8),
    ("llama-3.2-vision-90b", 8)])
def test_prefill_warm_up_leaves_a_live_engine_bit_identical(arch, page_size):
    """The warm-up runs of a capture (the body on quiesced inputs: every
    write at slot 0 and at the trash page, or page 0 of a plain pool) on a
    live engine leave every leaf, pool pages included, and the slot state
    exactly as they were, for a new key and for a built one; serving then
    finishes with every page back."""
    eng = _live_engine(arch, page_size=page_size)

    def state():
        return [t.clone() for t in (*eng._cache.values(), eng._tok,
                                    eng._pos, eng._rem_dev, eng._plen_dev)]

    before = state()
    for key in ((3, 16), next(iter(eng._prefill_fns))):
        prog = eng._prefill_fns.get(key)
        if prog is None:
            from repro_torch.serving.engine import _PrefillProgram
            prog = _PrefillProgram(eng, *key)
        with eng._prefill_quiesced(prog), torch.no_grad():
            eng._prefill_body(prog)
            assert not all(torch.equal(a, b)
                           for a, b in zip(before, state()))
        for a, b in zip(before, state()):
            assert torch.equal(a, b)
    while eng.busy:
        eng.step()
    if eng._alloc is not None:
        assert eng._alloc.n_free == eng.n_pages
