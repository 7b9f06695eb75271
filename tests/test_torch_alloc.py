"""The port's page allocator under staged and optimistic admission.

Mirrors the allocator halves of the reference's ``test_preemption.py`` (a
seeded fuzz and the strict reservation); the staged and optimistic
property tests are in ``test_torch_property_alloc.py``. Staged tickets hold
worst-case reservations and are re-keyed onto the slot that takes them;
optimistic reservations may over-commit, growth is gated by
``can_cover``, preemption releases a victim's pages and re-admission waits
for its whole worst case in free pages. No interleaving double-books a
page, free + held pages stay equal to the pool, and a drain returns every
page. The same op sequences run through the reference's allocator, which
must agree on every page handed out.
"""
import numpy as np
import pytest

from repro.serving.engine import PageAllocator as JAllocator
from repro_torch.serving.engine import PageAllocator


def _invariants(alloc, strict=True):
    live = alloc.live_pages()
    assert len(live) == len(set(live)), "page double-held"
    assert all(0 <= p < alloc.n_pages for p in live)
    assert len(live) + alloc.n_free == alloc.n_pages
    assert alloc.n_avail == alloc.n_free
    for holder, pages in alloc._pages.items():
        assert len(pages) <= alloc._reserved[holder]
    if strict:
        assert alloc.committed <= alloc.n_pages


class _Pair:
    """The port's allocator beside the reference's, driven alike."""

    def __init__(self, n_pages, page_size):
        self.t = PageAllocator(n_pages, page_size)
        self.j = JAllocator(n_pages, page_size)

    def __getattr__(self, name):
        tf, jf = getattr(self.t, name), getattr(self.j, name)
        if not callable(tf):
            assert tf == jf, name
            return tf

        def both(*a, **k):
            got, want = tf(*a, **k), jf(*a, **k)
            assert got == want, (name, a, got, want)
            return got
        return both


def test_allocator_optimistic_fuzz_preempt_readmit():
    """Seeded fuzz of optimistic reserve / cover / preempt-release /
    re-admit: no page double-held, free + held == n_pages at every step,
    a full drain returns everything, and the reference's allocator hands
    out the same pages."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        n_pages = int(rng.integers(2, 12))
        page = int(rng.integers(1, 5))
        alloc = _Pair(n_pages, page)
        live, parked, nxt = {}, [], 0
        for _ in range(60):
            op = rng.integers(4)
            if op == 0:
                npos = int(rng.integers(1, n_pages * page + 1))
                alloc.reserve(("h", nxt), npos, strict=False)
                live[("h", nxt)] = npos
                nxt += 1
            elif op == 1 and live:
                h = list(live)[int(rng.integers(len(live)))]
                npos = int(rng.integers(1, live[h] + 1))
                if alloc.can_cover(h, npos):
                    alloc.cover(h, npos)
            elif op == 2 and live:
                h = list(live)[int(rng.integers(len(live)))]
                alloc.release(h)
                parked.append((h, live.pop(h)))
            elif op == 3 and parked:
                h, npos = parked.pop(0)
                if alloc.pages_needed(npos) <= alloc.n_free:
                    alloc.reserve(h, npos, strict=False)
                    alloc.cover(h, min(npos, page))
                    live[h] = npos
                else:
                    parked.insert(0, (h, npos))
            _invariants(alloc.t, strict=False)
        for h in list(live):
            alloc.release(h)
        assert alloc.n_free == alloc.n_pages, f"trial {trial} leaked"
        assert alloc.committed == 0


def test_allocator_strict_reserve_still_refuses_overcommit():
    alloc = PageAllocator(4, 8)
    alloc.reserve("a", 32)                  # exactly the pool
    with pytest.raises(ValueError, match="over-committed"):
        alloc.reserve("b", 1)
    alloc.reserve("c", 8, strict=False)     # optimistic over-commit
    assert alloc.committed == 5
    assert alloc.can_cover("a", 32) and alloc.cover("a", 32) == [0, 1, 2, 3]
    assert not alloc.can_cover("c", 8)
    alloc.release("a")
    alloc.release("c")
    assert alloc.n_free == 4 and alloc.committed == 0


def test_allocator_rekey_moves_a_staged_ticket_onto_a_slot():
    alloc = PageAllocator(6, 4)
    alloc.reserve(0, 8)
    alloc.reserve(("stage", 0), 12)
    pages = alloc.cover(("stage", 0), 4)
    with pytest.raises(ValueError, match="already live"):
        alloc.rekey(("stage", 0), 0)
    alloc.release(0)
    alloc.rekey(("stage", 0), 0)
    assert alloc.pages_of(0) == pages and alloc.pages_of(("stage", 0)) == []
    assert alloc.cover(0, 12) and alloc.committed == 3
    alloc.release(0)
    assert alloc.n_free == 6 and alloc.committed == 0
