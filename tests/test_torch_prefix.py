"""The prefix cache with copy-on-write page sharing in the port, against
the JAX package, reduced size, f32, on the CPU.

Mirrors the reference's ``test_prefix_cache.py``: the host index (chained
digests, equal to the reference's; longest-run lookup, registration races,
eviction policies), the allocator's refcounts and copy-on-write, a seeded
fuzz of the sharing life cycle (also run by the reference's allocator,
which must evict the same pages), and the engine: with the prefix cache on
the greedy tokens equal the cache-off paged engine's and the JAX
contiguous engine's, across chunked prefill, the staging ring, optimistic
admission with preemption, a forced preempt whose replay re-hits the
cache, and a full-page hit that must copy on write; the hit, reuse, skip,
copy and eviction counts equal the JAX engine's with the same knobs. The
reference's hybrid clamp becomes the audio and vlm clamp (per-slot state
cannot be rebuilt from shared pages).

Port-only: ``plan_segment`` (which sets a segment's graph replays) agrees
with the step body's completion log for seats that start past 0, as a
prefix hit seats them.
"""
import numpy as np
import pytest
import torch

from repro.serving.engine import PageAllocator as JAllocator
from repro.serving.engine import PrefixCache as JPrefixCache
from repro_torch.serving.engine import (PageAllocator, PrefixCache, Request,
                                        ServingEngine, plan_segment)

from test_torch_layout import (assert_counts, assert_tokens, built, jax_run,
                               mixed_stream, port_run)

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)


def _invariant(alloc):
    """free + cached + unique live pages == the pool; refcounts match the
    holder lists exactly."""
    live = alloc.live_pages()
    uniq = set(live)
    assert len(alloc._free) + alloc.n_cached + len(uniq) == alloc.n_pages
    counts = {}
    for p in live:
        counts[p] = counts.get(p, 0) + 1
    assert counts == dict(alloc._refcnt)
    assert not (uniq & set(alloc._cached))
    assert not (uniq & set(alloc._free))


# ---------------------------------------------------------------------------
# PrefixCache and the allocator's sharing half, host side


def test_chain_digests_commit_to_whole_prefix():
    alloc = PageAllocator(8, 4)
    pc = PrefixCache(alloc, 4)
    toks = np.arange(13, dtype=np.int32)        # 3 full pages + 1 spare
    c = pc.chain(toks)
    assert len(c) == 3                          # a partial page never hashes
    assert c == JPrefixCache(JAllocator(8, 4), 4).chain(toks)
    other = toks.copy()
    other[5] = 999
    c2 = pc.chain(other)
    assert c2[0] == c[0]
    assert c2[1] != c[1] and c2[2] != c[2]
    head = toks.copy()
    head[0] = 999
    assert all(a != b for a, b in zip(pc.chain(head), c))


def test_register_lookup_longest_indexed_run():
    alloc = PageAllocator(8, 4)
    pc = PrefixCache(alloc, 4)
    toks = np.arange(12, dtype=np.int32)
    digests = pc.chain(toks)
    alloc.reserve("a", 12)
    pages = alloc.cover("a", 12)
    pc.register(digests, pages)
    assert pc.lookup(toks) == pages
    assert pc.lookup(toks[:8]) == pages[:2]
    assert pc.lookup(toks[:7]) == pages[:1]
    assert pc.lookup(np.arange(100, 112, dtype=np.int32)) == []
    pc.unindex(pages[1])
    assert pc.lookup(toks) == pages[:1]
    _invariant(alloc)


def test_register_race_keeps_first_page():
    """Two slots racing one prompt keep their own copies; the first
    registration wins and the loser's page stays unindexed."""
    alloc = PageAllocator(8, 4)
    pc = PrefixCache(alloc, 4)
    toks = np.arange(4, dtype=np.int32)
    (h,) = pc.chain(toks)
    alloc.reserve("a", 4)
    alloc.reserve("b", 4)
    (pa,) = alloc.cover("a", 4)
    (pb,) = alloc.cover("b", 4)
    pc.register([h], [pa])
    pc.register([h], [pb])
    assert pc.lookup(toks) == [pa]
    assert pb not in pc._hash_of
    alloc.release("b")
    assert pb in alloc._free
    _invariant(alloc)


def test_release_retains_indexed_pages_until_pressure_evicts():
    """Indexed pages outlive their last holder (cached, refcount 0) and are
    reclaimed only when the free list is dry; eviction unindexes."""
    alloc = PageAllocator(3, 4)
    pc = PrefixCache(alloc, 4)
    toks = np.arange(8, dtype=np.int32)
    alloc.reserve("a", 8)
    pages = alloc.cover("a", 8)
    pc.register(pc.chain(toks), pages)
    alloc.release("a")
    assert alloc.n_free == 1 and alloc.n_cached == 2
    assert pc.lookup(toks) == pages
    _invariant(alloc)
    alloc.reserve("b", 12)
    got = alloc.cover("b", 12)
    assert len(got) == 3 and alloc.evictions == 2
    assert len(pc) == 0 and pc.lookup(toks) == []
    _invariant(alloc)


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_eviction_policy_order(policy):
    """lru evicts the page released longest ago, fifo the page registered
    first: re-touching page 0 flips lru's order and not fifo's. The
    reference's allocator evicts the same page."""
    got = []
    for alloc_cls, cache_cls in ((PageAllocator, PrefixCache),
                                 (JAllocator, JPrefixCache)):
        alloc = alloc_cls(2, 4)
        pc = cache_cls(alloc, 4, policy=policy)
        toks = np.arange(8, dtype=np.int32)
        alloc.reserve("a", 8)
        pages = alloc.cover("a", 8)
        pc.register(pc.chain(toks), pages)
        alloc.release("a")                      # cached: [p0, p1]
        alloc.reserve("t", 4)
        alloc.attach("t", [pages[0]])
        alloc.release("t")                      # lru order: [p1, p0]
        alloc.reserve("b", 4)
        (page,) = alloc.cover("b", 4)
        assert page == (pages[1] if policy == "lru" else pages[0])
        got.append(page)
        if alloc_cls is PageAllocator:
            _invariant(alloc)
    assert got[0] == got[1]


def test_attach_refcounts_and_cow_gives_private_page():
    alloc = PageAllocator(4, 4)
    pc = PrefixCache(alloc, 4)
    toks = np.arange(8, dtype=np.int32)
    alloc.reserve("a", 8)
    pages = alloc.cover("a", 8)
    pc.register(pc.chain(toks), pages)
    alloc.reserve("b", 8)
    alloc.attach("b", pages)
    assert alloc.refcount(pages[0]) == 2
    _invariant(alloc)
    old, new = alloc.cow("b", 1)
    assert old == pages[1] and new not in pages
    assert alloc.refcount(old) == 1 and alloc.refcount(new) == 1
    assert alloc.pages_of("a") == pages
    assert alloc.pages_of("b") == [pages[0], new]
    _invariant(alloc)
    alloc.release("a")
    alloc.release("b")
    assert alloc.n_cached == 2 and alloc.n_free == 2
    _invariant(alloc)


def test_bad_policy_rejected():
    with pytest.raises(ValueError, match="policy"):
        PrefixCache(PageAllocator(2, 4), 4, policy="mru")


# ---------------------------------------------------------------------------
# randomized interleavings of the sharing life cycle


def run_share_ops(ops, n_pages, page_size, max_slots, alloc_cls=PageAllocator):
    """Drive an allocator through the sharing life cycle — admit, grow,
    register, attach (a hit), cow (a write to a shared page), finish
    (release keeps indexed pages cached), eviction under pressure —
    checking after every op that free + cached + unique held pages ==
    the pool, that every refcount equals the holders listing the page,
    that eviction takes only pages of refcount 0 and that ``cow`` hands
    back a private page. Returns the evicted pages in order (the
    reference's ``run_share_ops``, for either allocator)."""
    alloc = alloc_cls(n_pages, page_size)
    indexed = set()
    alloc.retain = lambda p: p in indexed
    evicted = []

    def on_evict(p):
        assert alloc.refcount(p) == 0, "evicted a referenced page"
        indexed.discard(p)
        evicted.append(p)

    alloc.on_evict = on_evict
    live = {}
    next_h = 0
    for kind, pick, npos in ops:
        npos = min(npos, n_pages * page_size)
        if kind == "admit":
            if len(live) >= max_slots or not alloc.can_reserve(npos):
                continue
            h = ("h", next_h)
            next_h += 1
            alloc.reserve(h, npos)
            alloc.cover(h, min(npos, page_size))
            live[h] = npos
        elif kind == "grow" and live:
            h = sorted(live)[pick % len(live)]
            grown = alloc.cover(h, npos)
            assert len(grown) == len(set(grown))
        elif kind == "register" and live:
            h = sorted(live)[pick % len(live)]
            pages = alloc.pages_of(h)
            if pages:
                indexed.add(pages[pick % len(pages)])
        elif kind == "attach" and live:
            h = sorted(live)[pick % len(live)]
            room = alloc.pages_needed(live[h]) - len(alloc.pages_of(h))
            cand = sorted(indexed)
            if cand and room > 0:
                alloc.attach(h, [cand[pick % len(cand)]])
        elif kind == "cow" and live:
            h = sorted(live)[pick % len(live)]
            pages = alloc.pages_of(h)
            shared = [i for i, p in enumerate(pages)
                      if alloc.refcount(p) > 1]
            if shared and alloc.n_avail > 0:
                idx = shared[pick % len(shared)]
                old, new = alloc.cow(h, idx)
                assert alloc.refcount(new) == 1
                assert alloc.refcount(old) >= 1
                assert alloc.pages_of(h)[idx] == new
        elif kind == "finish" and live:
            h = sorted(live)[pick % len(live)]
            alloc.release(h)
            del live[h]
        held = alloc.live_pages()
        uniq = set(held)
        assert alloc.n_free + alloc.n_cached + len(uniq) == n_pages, \
            "free + cached + unique live != pool"
        counts = {}
        for p in held:
            counts[p] = counts.get(p, 0) + 1
        assert counts == dict(alloc._refcnt), "refcount drift"
        assert all(p in indexed for p in alloc._cached), \
            "cached page not indexed"
        assert not uniq & set(alloc._cached) and not uniq & set(alloc._free)
    for h in sorted(live):
        alloc.release(h)
    assert alloc.n_free + alloc.n_cached == n_pages
    assert alloc.committed == 0 and not alloc.live_pages()
    return evicted


SHARE_KINDS = ["admit", "grow", "register", "attach", "cow", "finish"]


def test_seeded_fuzz_sharing_invariants():
    """200 seeded interleavings: the sharing invariants hold throughout,
    the pressure path runs, and the reference's allocator evicts the same
    pages in the same order."""
    rng = np.random.default_rng(0x5EED)
    total_evictions = 0
    for _ in range(200):
        n_pages = int(rng.integers(1, 33))
        page_size = int(rng.integers(1, 13))
        max_slots = int(rng.integers(1, 7))
        ops = [(SHARE_KINDS[int(rng.integers(len(SHARE_KINDS)))],
                int(rng.integers(0, 2**31 - 1)), int(rng.integers(1, 97)))
               for _ in range(int(rng.integers(1, 81)))]
        got = run_share_ops(ops, n_pages, page_size, max_slots)
        assert got == run_share_ops(ops, n_pages, page_size, max_slots,
                                    JAllocator)
        total_evictions += len(got)
    assert total_evictions > 0


# ---------------------------------------------------------------------------
# the engine: prefix on == off == the JAX engine


def shared_stream(vocab=256, n=10, seed=3):
    """Most prompts open with one of two templates (two full 8-wide pages
    or more), as the reference's ``_shared_stream``."""
    rng = np.random.default_rng(seed)
    t1 = rng.integers(0, vocab, size=24).astype(np.int32)
    t2 = rng.integers(0, vocab, size=17).astype(np.int32)
    out = []
    for i in range(n):
        tpl = t1 if i % 2 == 0 else t2
        sfx = rng.integers(0, vocab,
                           size=int(rng.integers(2, 7))).astype(np.int32)
        out.append((np.concatenate([tpl, sfx]), int(rng.integers(3, 9))))
    return out


GEOM = dict(max_batch=4, max_len=64, decode_block=8)
PAGED = dict(GEOM, page_size=8, n_pages=24, chunk_threshold=12)


def base_tokens(spec, label="shared"):
    """The JAX contiguous engine's tokens: the reference's oracle."""
    return jax_run("llama3.2-1b", label, spec, page_size=None, **GEOM)[0]


def drained(eng):
    assert eng._alloc.n_free + eng._alloc.n_cached == eng.n_pages
    assert eng._alloc.committed == 0 and not eng._alloc.live_pages()


def test_prefix_cache_bit_identical_and_counts():
    spec = shared_stream()
    base = base_tokens(spec)
    off, _, e_off, _ = port_run("llama3.2-1b", spec, **PAGED)
    _, jorder, jstats, _ = jax_run("llama3.2-1b", "shared", spec,
                                   prefix_cache=True, **PAGED)
    on, order, e_on, _ = port_run("llama3.2-1b", spec, prefix_cache=True,
                                  **PAGED)
    assert_tokens(off, base, "off:")
    assert_tokens(on, base, "on:")
    assert order == jorder
    assert_counts(e_on, jstats)
    assert e_off.stats["prefix_hits"] == 0
    s = e_on.stats
    assert s["prefix_hits"] > 0
    assert s["prefix_tokens_skipped"] >= s["prefix_hits"] * 8
    assert s["prefix_pages_reused"] * 8 >= s["prefix_tokens_skipped"]
    occ = e_on.occupancy
    for key in ("prefix_hits", "prefix_pages_reused", "cow_copies",
                "evictions", "prefix_tokens_skipped"):
        assert occ[key] == float(s[key])
    drained(e_on)


def test_prefix_cache_with_staging_ring():
    """Staged seats never look the cache up but their pages register."""
    spec = shared_stream()
    kw = dict(PAGED, stage_slots=2, prefix_cache=True)
    _, jorder, jstats, _ = jax_run("llama3.2-1b", "shared", spec, **kw)
    got, order, eng, _ = port_run("llama3.2-1b", spec, **kw)
    assert_tokens(got, base_tokens(spec))
    assert order == jorder
    assert_counts(eng, jstats)
    assert eng.stats["inseg_admissions"] > 0
    assert len(eng._prefix) > 0
    drained(eng)


def test_prefix_cache_under_optimistic_preemption():
    """A small pool: optimistic admission preempts and the cache evicts
    under pressure; tokens still equal, counts the JAX engine's."""
    spec = shared_stream()
    kw = dict(PAGED, n_pages=12, admission="optimistic", prefix_cache=True)
    _, jorder, jstats, _ = jax_run("llama3.2-1b", "shared", spec, **kw)
    got, order, eng, _ = port_run("llama3.2-1b", spec, **kw)
    assert_tokens(got, base_tokens(spec))
    assert order == jorder
    assert_counts(eng, jstats)
    assert eng.stats["preemptions"] > 0
    drained(eng)


def _preempt_first_live(eng, n):
    if n == 0:
        eng.preempt(next(s for s, r in enumerate(eng._slot_req)
                         if r is not None))


def test_forced_preempt_readmission_rehits():
    """A preempted victim's registered pages go cached at its release;
    its replay re-hits the index instead of recomputing the prefix."""
    spec = shared_stream()
    kw = dict(PAGED, prefix_cache=True)
    _, jorder, jstats, jeng = jax_run("llama3.2-1b", "shared+preempt",
                                      spec, hook=_preempt_first_live, **kw)
    hits = []

    def hook(eng, n):
        if n == 0:
            hits.append(eng.stats["prefix_hits"])
        _preempt_first_live(eng, n)

    got, order, eng, _ = port_run("llama3.2-1b", spec, hook=hook, **kw)
    assert_tokens(got, base_tokens(spec))
    assert order == jorder
    assert_counts(eng, jstats)
    assert eng.stats["preemptions"] == 1
    assert eng.stats["prefix_hits"] > hits[0]
    drained(eng)


def _cow_scenario(eng, cls, prompt):
    """Two live requests of one prompt of whole pages: the second seats
    after the first's pages registered, so its seat writes ``plen - 1``
    inside the last shared page."""
    a = cls(rid=0, prompt=prompt.copy(), max_new_tokens=12)
    b = cls(rid=1, prompt=prompt.copy(), max_new_tokens=4)
    eng.submit(a)
    while len(eng._prefix) < 2:
        eng.step()
    assert eng.busy                     # a is still decoding
    eng.submit(b)
    while eng.busy:
        eng.step()
    return a, b


def test_full_page_hit_triggers_cow():
    """The full-page hit copies the shared page on write (the first
    request still reads the original): one hit, one copy, and both
    requests' tokens those of solo serves, on the port and the JAX
    engine alike."""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    jm, jp, tm, tp = built()
    prompt = np.random.default_rng(11).integers(0, 256, size=16) \
        .astype(np.int32)                                   # 2 pages
    kw = dict(max_batch=2, max_len=64, decode_block=4, page_size=8,
              n_pages=16, chunk_threshold=12, prefix_cache=True)
    got = {}
    for name, eng, cls in (("port", ServingEngine(tm, tp, **kw), Request),
                           ("jax", JEngine(jm, jp, **kw), JRequest)):
        a, b = _cow_scenario(eng, cls, prompt)
        assert eng.stats["prefix_hits"] == 1, name
        assert eng.stats["cow_copies"] == 1, name
        got[name] = (np.asarray(a.tokens), np.asarray(b.tokens))
    for new, i in ((12, 0), (4, 1)):
        solo, _, _, _ = port_run("llama3.2-1b", [(prompt, new)],
                                 max_batch=2, max_len=64, decode_block=4,
                                 page_size=None)
        np.testing.assert_array_equal(got["port"][i], solo[0])
        np.testing.assert_array_equal(got["jax"][i], solo[0])


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_audio_and_vlm_clamp_prefix_cache_off(arch):
    """Audio's ``enc_len`` and vlm's image k/v are per-slot state that
    shared pages cannot rebuild (and both admit whole prompts): the knob
    clamps off, as the reference clamps it for its hybrid family, and the
    tokens stay the JAX contiguous engine's."""
    from repro.configs.registry import ARCHS as J_ARCHS
    spec = mixed_stream(J_ARCHS[arch].reduced().vocab)
    kw = dict(max_batch=3, max_len=64, decode_block=4, min_bucket=4)
    want = jax_run(arch, "mixed", spec, page_size=None, **kw)[0]
    got, _, eng, _ = port_run(arch, spec, page_size=8, chunk_threshold=12,
                              prefix_cache=True, **kw)
    assert eng._prefix is None
    assert_tokens(got, want)
    assert eng.stats["prefix_hits"] == 0


# ---------------------------------------------------------------------------
# the host plan of a segment with seats past position 0


def test_plan_matches_device_log_for_seats_past_zero():
    """Seeded fuzz: slots seated at ``start`` > 0 (a prefix hit's seat),
    some still feeding, some emitting, beside a staged FIFO; the segment's
    device log, emissions, busy count and ring head must equal
    ``plan_segment``'s (``_decode_segment`` raises otherwise), and the
    device's positions the plan's."""
    _, _, tm, tp = built()
    eng = ServingEngine(tm, tp, max_batch=4, max_len=64, decode_block=8,
                        page_size=8, stage_slots=3)
    rng = np.random.default_rng(7)
    n_seated = 0
    for trial in range(25):
        for s in range(eng.max_batch):
            if rng.random() < 0.2:
                eng._rem[s] = 0
                eng._rem_dev[s] = 0
                continue
            n = int(rng.integers(2, 30))
            start = int(rng.integers(0, n))
            prefix = rng.integers(0, 256, size=n).astype(np.int32)
            eng._seat_prefix(s, prefix, int(rng.integers(1, 10)),
                             start=start)
            assert int(eng._pos[s]) == start == eng._slot_pos[s]
            assert int(eng._tok[s, 0]) == prefix[start]
            n_seated += start > 0
        eng._staged.clear()
        for _ in range(int(rng.integers(0, 4))):
            r = Request(rid=0, prompt=rng.integers(
                0, 256, size=int(rng.integers(1, 12))).astype(np.int32),
                max_new_tokens=int(rng.integers(1, 6)))
            eng._staged.append((r, None, np.full((eng.pages_per_slot,),
                                                 eng.n_pages, np.int32)))
        eng._ring_stale = True
        plan = plan_segment(eng._rem, eng._slot_pos, eng._plen,
                            [(len(r.prompt), r.max_new_tokens)
                             for r, _t, _b in eng._staged],
                            eng.decode_block)
        if plan.n_steps:
            eng._decode_segment(plan)
        np.testing.assert_array_equal(eng._pos.numpy(), plan.pos)
        np.testing.assert_array_equal(eng._rem_dev.numpy(), plan.rem)
        eng._rem, eng._slot_pos, eng._plen = plan.rem, plan.pos, plan.plen
    assert n_seated > 20
