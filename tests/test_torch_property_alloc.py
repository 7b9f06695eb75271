"""Property tests (hypothesis) of the port's page allocator under staged
and optimistic admission, prefix sharing and host swap, mirrors of the
reference's ``test_property_paged_alloc.py``; each op sequence also runs
through the reference's allocator, which must hand out (and evict) the
same pages."""
import pytest
import torch

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

pytest.importorskip("hypothesis")
from hypothesis import (HealthCheck, given, settings,  # noqa: E402
                        strategies as st)

from test_torch_alloc import _Pair, _invariants  # noqa: E402

STAGE_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "stage", "grow", "promote",
                               "finish"]),
              st.integers(0, 2**31 - 1), st.integers(1, 96)),
    min_size=1, max_size=80)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(STAGE_OPS, st.integers(1, 48), st.integers(1, 16), st.integers(1, 8))
def test_staged_reservations_invariants(ops, n_pages, page_size, max_slots):
    """The staging discipline: tickets hold worst-case reservations (first
    stride covered at staging time) that gate admission, a promotion
    releases a finished slot and re-keys the oldest ticket onto it, and
    free + staged + live == pool throughout."""
    alloc = _Pair(n_pages, page_size)
    live, staged = {}, {}
    next_slot = next_ticket = 0
    for kind, pick, npos in ops:
        if kind == "admit":
            if next_slot >= max_slots or not alloc.can_reserve(npos):
                continue
            alloc.reserve(next_slot, npos)
            live[next_slot] = npos
            alloc.cover(next_slot, min(npos, page_size))
            next_slot += 1
        elif kind == "stage":
            if not alloc.can_reserve(npos):
                continue
            ticket = ("stage", next_ticket)
            next_ticket += 1
            alloc.reserve(ticket, npos)
            alloc.cover(ticket, min(npos, page_size))
            staged[ticket] = npos
        elif kind == "grow" and live:
            slot = sorted(live)[pick % len(live)]
            alloc.cover(slot, npos)
            assert len(alloc.pages_of(slot)) <= \
                alloc.pages_needed(live[slot])
        elif kind == "promote" and staged and live:
            slot = sorted(live)[pick % len(live)]
            alloc.release(slot)
            del live[slot]
            ticket = sorted(staged)[0]
            alloc.rekey(ticket, slot)
            live[slot] = staged.pop(ticket)
        elif kind == "finish" and live:
            slot = sorted(live)[pick % len(live)]
            alloc.release(slot)
            del live[slot]
        held = alloc.live_pages()
        staged_pages = sum(len(alloc.pages_of(t)) for t in staged)
        live_pages = sum(len(alloc.pages_of(s)) for s in live)
        assert staged_pages + live_pages == len(held)
        assert alloc.n_free + staged_pages + live_pages == alloc.n_pages
        _invariants(alloc.t)
    for holder in sorted(staged) + sorted(live):
        alloc.release(holder)
    assert alloc.n_free == alloc.n_pages and alloc.committed == 0


PREEMPT_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "grow", "preempt", "readmit",
                               "finish"]),
              st.integers(0, 2**31 - 1), st.integers(1, 96)),
    min_size=1, max_size=100)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(PREEMPT_OPS, st.integers(1, 48), st.integers(1, 16),
       st.integers(1, 8))
def test_optimistic_preempt_readmit_invariants(ops, n_pages, page_size,
                                               max_slots):
    """The optimistic discipline: strict=False reservations, growth gated
    by ``can_cover``, preemption releasing a victim's pages, re-admission
    waiting for its whole worst case in free pages."""
    alloc = _Pair(n_pages, page_size)
    live, parked, next_h = {}, [], 0
    for kind, pick, npos in ops:
        npos = min(npos, n_pages * page_size)   # submit()-time validation
        if kind == "admit":
            if len(live) >= max_slots or \
                    alloc.pages_needed(min(npos, page_size)) > alloc.n_free:
                continue
            h = ("h", next_h)
            next_h += 1
            alloc.reserve(h, npos, strict=False)
            alloc.cover(h, min(npos, page_size))
            live[h] = npos
        elif kind == "grow" and live:
            h = sorted(live)[pick % len(live)]
            if alloc.can_cover(h, npos):
                alloc.cover(h, npos)
        elif kind == "preempt" and live:
            h = sorted(live)[pick % len(live)]
            alloc.release(h)
            parked.append((h, live.pop(h)))
        elif kind == "readmit" and parked:
            h, want = parked[0]
            if alloc.pages_needed(want) > alloc.n_free:
                continue
            parked.pop(0)
            alloc.reserve(h, want, strict=False)
            alloc.cover(h, min(want, page_size))
            live[h] = want
        elif kind == "finish" and live:
            h = sorted(live)[pick % len(live)]
            alloc.release(h)
            del live[h]
        _invariants(alloc.t, strict=False)
    for h in sorted(live):
        alloc.release(h)
    assert alloc.n_free == alloc.n_pages and alloc.committed == 0
    for h, want in parked:                  # every parked holder fits
        assert alloc.pages_needed(want) <= alloc.n_pages


SHARE_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "grow", "register", "attach",
                               "cow", "finish"]),
              st.integers(0, 2**31 - 1), st.integers(1, 96)),
    min_size=1, max_size=100)

# the op runners live beside their seeded fuzz mirrors, which run without
# hypothesis
from test_torch_prefix import run_share_ops  # noqa: E402
from test_torch_swap import run_swap_ops  # noqa: E402
from repro.serving.engine import PageAllocator as JAllocator  # noqa: E402


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(SHARE_OPS, st.integers(1, 48), st.integers(1, 16), st.integers(1, 8))
def test_refcount_sharing_invariants(ops, n_pages, page_size, max_slots):
    """Refcounts, the cached pool and copy-on-write: free + cached +
    unique held pages == the pool, refcounts equal the holder lists; the
    reference evicts the same pages."""
    got = run_share_ops(ops, n_pages, page_size, max_slots)
    assert got == run_share_ops(ops, n_pages, page_size, max_slots,
                                JAllocator)


@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(SHARE_OPS, st.integers(1, 8), st.integers(1, 4))
def test_sharing_under_pressure_evicts_only_cached(ops, n_pages,
                                                   page_size):
    """Tiny pools force the evict path: the on_evict hook's refcount-0
    check (inside run_share_ops) is what this case exists to exercise."""
    got = run_share_ops(ops, n_pages, page_size, max_slots=4)
    assert got == run_share_ops(ops, n_pages, page_size, 4, JAllocator)


SWAP_OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "grow", "swap", "recompute",
                               "readmit", "finish"]),
              st.integers(0, 2**31 - 1), st.integers(1, 96)),
    min_size=1, max_size=100)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(SWAP_OPS, st.integers(1, 48), st.integers(1, 16), st.integers(1, 8))
def test_swap_parking_invariants(ops, n_pages, page_size, max_slots):
    """Host-swap parking rides the optimistic preempt / re-admit cycle: a
    parked holder, with or without a payload, owns no pages, and a
    swap-in gets its exact page count back in one stride."""
    run_swap_ops(ops, n_pages, page_size, max_slots)
