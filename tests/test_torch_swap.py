"""Host swap (``swap="host"``) in the port, against the JAX package,
reduced size, f32, on the CPU.

Mirrors the reference's ``test_swap.py``: knob validation; a victim
preempted with swap on is restored from its host pages with no replay and
finishes with the tokens of an uninterrupted run and of the recompute
path; the contiguous layout and an exhausted budget fall back to
recompute and count it; ``cancel_overdue`` releases a parked payload's
budget; and the seeded fuzz of the swap discipline, run by the port's and
the reference's allocators alike. The swap, fallback and byte counts equal
the JAX engine's with the same knobs. Beyond the reference: swap under
optimistic admission, where the pool's pressure picks the victims.
(The reference's recurrent-family fallback waits for those families.)
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.serving.engine import Request, ServingEngine

from test_torch_alloc import _Pair
from test_torch_layout import (assert_counts, assert_tokens, built, jax_run,
                               port_run)

# six xdist workers share the cores with XLA's threads: one torch thread
# each keeps them from oversubscribing
torch.set_num_threads(1)

KW = dict(max_batch=2, max_len=64, decode_block=4, min_bucket=4)


def stream(n=6, seed=11, max_new=(6, 13)):
    """The reference's ``test_preemption._stream``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=int(rng.integers(3, 10))
                          ).astype(np.int32), int(rng.integers(*max_new)))
            for _ in range(n)]


def preempt_first(eng, n):
    """After the first step, preempt the first live slot."""
    if n == 0:
        eng.preempt(next(s for s in range(eng.max_batch)
                         if eng._slot_req[s] is not None))


def reference(spec):
    """The JAX paged engine's uninterrupted tokens."""
    return jax_run("llama3.2-1b", "swap", spec, page_size=8, **KW)[0]


def both(spec, **kw):
    """The port and the JAX engine under the same forced preemption:
    tokens equal the uninterrupted run's, order and counts the JAX
    engine's. Returns the port engine."""
    _, jorder, jstats, _ = jax_run("llama3.2-1b", "swap+preempt", spec,
                                   hook=preempt_first, **dict(KW, **kw))
    got, order, eng, _ = port_run("llama3.2-1b", spec, hook=preempt_first,
                                  **dict(KW, **kw))
    assert_tokens(got, reference(spec))
    assert order == jorder
    assert_counts(eng, jstats)
    return eng


def test_swap_knob_validation():
    _, _, tm, tp = built()
    with pytest.raises(ValueError, match="swap"):
        ServingEngine(tm, tp, swap="device")


def test_swap_recovery_bit_identical():
    """The restored pages and (tok, pos, rem) are exactly what the victim
    was parked with: the tokens of the uninterrupted run and of the
    recompute path, no fallback, and the budget and the pool drain."""
    spec = stream()
    rec = both(spec, page_size=8)
    assert rec.stats["preemptions"] >= 1 and rec.stats["swap_out"] == 0
    sw = both(spec, page_size=8, swap="host", swap_budget_bytes=64 << 20)
    s = sw.stats
    assert s["swap_out"] == 1 and s["swap_in"] == 1
    assert s["swap_fallbacks"] == 0 and s["swap_bytes"] > 0
    assert s["preempt_readmits"] >= 1
    assert rec.stats["decode_steps"] > s["decode_steps"]   # no replay
    assert sw._swap_live_bytes == 0
    assert sw._alloc.n_free == sw.n_pages and sw._alloc.committed == 0


def test_swap_contiguous_falls_back_to_recompute():
    """The contiguous layout has no pages to copy: swap counts a fallback
    and the recompute path gives the same tokens."""
    eng = both(stream(), page_size=None, swap="host")
    assert eng.stats["swap_fallbacks"] >= 1
    assert eng.stats["swap_out"] == 0 and eng.stats["swap_in"] == 0
    assert eng._swap_live_bytes == 0


def test_swap_budget_exhaustion_falls_back():
    """A one-byte budget refuses every copy: recovery recomputes."""
    eng = both(stream(), page_size=8, swap="host", swap_budget_bytes=1)
    assert eng.stats["swap_fallbacks"] >= 1
    assert eng.stats["swap_out"] == 0
    assert eng._swap_live_bytes == 0


def test_swap_under_optimistic_pressure_matches_jax():
    """Optimistic admission on a tight pool picks the victims; each one
    past its prompt is swapped and restored, the tokens are a worst-case
    serve's and the counts the JAX engine's."""
    spec = stream(8, seed=3)
    kw = dict(max_batch=4, max_len=64, decode_block=4, min_bucket=4,
              page_size=4, n_pages=12, admission="optimistic", swap="host")
    want = jax_run("llama3.2-1b", "swap8", spec, page_size=4,
                   max_batch=4, max_len=64, decode_block=4, min_bucket=4)[0]
    _, jorder, jstats, _ = jax_run("llama3.2-1b", "swap8", spec, **kw)
    got, order, eng, _ = port_run("llama3.2-1b", spec, **kw)
    assert_tokens(got, want)
    assert order == jorder
    assert_counts(eng, jstats)
    s = eng.stats
    assert s["swap_out"] == s["swap_in"] >= 1 and s["preemptions"] >= 1
    assert eng._swap_live_bytes == 0 and eng._alloc.n_free == eng.n_pages


def test_swap_ok_is_the_gate_of_every_forced_preempt():
    """``_swap_ok`` is the state gate of ``_swap_out``: a forced preempt
    swaps exactly when it holds, for victims still feeding their prompts
    and victims past them alike, and the run still finishes with the
    uninterrupted tokens."""
    spec = stream()
    seen = []

    def hook(eng, n):
        live = [s for s in range(eng.max_batch)
                if eng._slot_req[s] is not None]
        if n % 2 or not live or len(seen) >= 6:
            return
        ok = eng._swap_ok(live[0])
        before = eng.stats["swap_out"]
        eng.preempt(live[0])
        seen.append((ok, eng.stats["swap_out"] - before))

    got, _, eng, _ = port_run("llama3.2-1b", spec, hook=hook, page_size=8,
                              swap="host", chunk_threshold=0, **KW)
    assert_tokens(got, reference(spec))
    assert {ok for ok, _ in seen} == {True, False}, seen
    assert all(int(ok) == swapped for ok, swapped in seen), seen
    assert eng._swap_live_bytes == 0


def test_cancel_overdue_releases_parked_swap_budget():
    """Cancelling a parked victim returns its payload's budget charge and
    completes it with the tokens it had at preemption."""
    _, _, tm, tp = built()
    eng = ServingEngine(tm, tp, max_batch=1, max_len=64, decode_block=4,
                        min_bucket=4, page_size=8, swap="host")
    rng = np.random.default_rng(3)
    r = Request(rid=0, prompt=rng.integers(0, 256, size=6).astype(np.int32),
                max_new_tokens=20, slo=0.5)
    eng.submit(r)
    eng.step()
    eng.preempt(0)
    assert eng.stats["swap_out"] == 1 and eng._swap_live_bytes > 0
    assert eng.cancel_overdue(now=time.perf_counter() + 60.0) == 1
    eng.drain_completions()
    assert r.cancelled and len(r.tokens) > 0
    assert eng._swap_live_bytes == 0, "cancelled payload still charged"
    assert eng._alloc.n_free == eng.n_pages and eng._alloc.committed == 0
    assert not eng.busy


# ---------------------------------------------------------------------------
# allocator invariants under swap interleavings (no model)


def run_swap_ops(ops, n_pages, page_size, max_slots):
    """The swap discipline on the allocator (the reference's
    ``run_swap_ops``), through the port's and the reference's allocators
    at once: preemption releases a victim's pages whether it parks with a
    host payload or for recompute; a swap-in covers exactly the pages it
    copied, a recompute re-grows from its first stride. No parked holder
    keeps pages, none is held twice, and the free count stays exact."""
    alloc = _Pair(n_pages, page_size)
    live, parked, nxt = {}, [], 0
    for kind, pick, npos in ops:
        npos = min(npos, n_pages * page_size)    # submit()-time validation
        if kind == "admit":
            if len(live) >= max_slots:
                continue
            h = ("h", nxt)
            nxt += 1
            if alloc.pages_needed(min(npos, page_size)) > alloc.n_free:
                continue
            alloc.reserve(h, npos, strict=False)
            alloc.cover(h, min(npos, page_size))
            live[h] = npos
        elif kind == "grow" and live:
            h = sorted(live)[pick % len(live)]
            if alloc.can_cover(h, npos):
                grown = alloc.cover(h, npos)
                assert len(grown) == len(set(grown))
        elif kind == "swap" and live:
            h = sorted(live)[pick % len(live)]
            held = len(alloc.pages_of(h))
            pages = alloc.release(h)
            assert len(pages) == len(set(pages))
            parked.append((h, live.pop(h), held))
        elif kind == "recompute" and live:
            h = sorted(live)[pick % len(live)]
            alloc.release(h)
            parked.append((h, live.pop(h), None))
        elif kind == "readmit" and parked:
            h, want, held = parked[0]
            if alloc.pages_needed(want) > alloc.n_free:
                continue
            parked.pop(0)
            alloc.reserve(h, want, strict=False)
            if held is None:
                alloc.cover(h, min(want, page_size))
            else:
                pages = alloc.cover(h, held * page_size)
                assert len(pages) == held, (len(pages), held)
            live[h] = want
        elif kind == "finish" and live:
            h = sorted(live)[pick % len(live)]
            pages = alloc.release(h)
            del live[h]
            assert len(pages) == len(set(pages))
        held_pages = alloc.live_pages()
        assert len(held_pages) == len(set(held_pages)), "double-booked"
        assert alloc.n_free + len(held_pages) == alloc.n_pages
        for h, _, _ in parked:
            assert alloc.pages_of(h) == [], \
                "parked holder still owns device pages"
        for h in live:
            assert len(alloc.pages_of(h)) <= alloc.pages_needed(live[h])
    for h in sorted(live):
        alloc.release(h)
    assert alloc.n_free == alloc.n_pages and alloc.committed == 0
    for h, want, held in parked:
        alloc.reserve(h, want, strict=False)
        if held is None:
            alloc.cover(h, want)
        else:
            assert len(alloc.cover(h, held * page_size)) == held
        alloc.release(h)
    assert alloc.n_free == alloc.n_pages and alloc.committed == 0


SWAP_KINDS = ["admit", "grow", "swap", "recompute", "readmit", "finish"]


def test_swap_ops_seeded_fuzz():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n_pages = int(rng.integers(2, 16))
        page = int(rng.integers(1, 6))
        ops = [(SWAP_KINDS[int(rng.integers(len(SWAP_KINDS)))],
                int(rng.integers(2**31 - 1)), int(rng.integers(1, 97)))
               for _ in range(80)]
        run_swap_ops(ops, n_pages, page, max_slots=int(rng.integers(1, 7)))
