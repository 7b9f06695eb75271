"""Continuous-batching serving engine over a paged or contiguous KV cache
(the open-loop core of ``repro.serving.engine``).

The engine owns the model's cache leaves, a per-slot block table, and
the per-slot decode loop state on the device. As in the JAX engine, each
leaf's batch and sequence axes are found by diffing ``model.cache_shapes``
at two batch sizes and at two lengths. A leaf with a sequence axis is *paged*: it
becomes a shared page pool (the batch axis dropped, the sequence axis split
into ``(n_pages, page_size)``) read and written through the block table —
dense and vlm self k/v, audio self and encoder k/v. A leaf without one is
*per-slot state*, indexed by slot — vlm's image k/v, audio's ``enc_len``.

Requests are admitted FIFO while the pool can hold their worst case
(``ceil((prompt + max_new - 1) / page_size)`` pages); same-bucket prompts
are prefilled together in one dispatch (admit batches bucketed to
{1, max_batch}), their paged leaves are scattered into the pools through
the block table and their state rows are written by slot. The audio and
vlm families get
all-zero stub encoder inputs at prefill, exactly as the JAX engine feeds
them (``frames`` of the prompt's bucket width, ``image_embeds`` of
``n_image_tokens``). A slot never admitted keeps ``enc_len`` 0 and a freed
slot a stale one; both are inactive, and what they compute is discarded.
Pages are appended to a slot's block table ahead of every decode segment
and returned the moment its sequence finishes.

**Decode segments.** The JAX engine runs a segment as one compiled
device program: a ``lax.while_loop`` over ``model.decode`` inside one
``jax.jit``, traced once per engine, over device-resident loop state. Here
the loop state is the reference's carry, held in static device buffers
allocated once: ``tok`` (B, 1), ``pos``, ``rem`` and ``plen`` (B,), the
prompt buffer ``pbuf`` (B, max_len), the staging ring, the emitted tokens
``out`` (B, decode_block), the completion log and a step counter, beside
the block table and every cache leaf. Host code writes them only in place.
One function, ``_step_body``, is the reference's loop body: decode one
token for every slot, take the argmax, feed the next prompt token instead
while a chunked prompt remains (``feeding``), write the emitted token (-1
where none) into ``out`` at the step counter, advance ``tok``, ``pos`` and
``rem`` where the slot is active (``rem > 0``), then log the slots that
finished this step and refill them from the staging ring (below). On the
CPU a segment calls it ``n_steps`` times. On the card it is captured once
per engine as a CUDA graph (``warmup()``, or the first ``step()``) and a
segment replays that graph ``n_steps`` times; a capture that fails raises,
and nothing falls back to the eager loop. A graph has no loop condition,
so the reference's early exit (``i < decode_block`` and some slot active)
is planned on the host: ``plan_segment`` runs the step's bookkeeping —
which slots are active, feed, emit, finish and are refilled from which
ring entry — on the host mirrors of ``rem``, ``pos`` and ``plen`` and the
staged FIFO. That is exact, because completions depend on lengths, never
on token values. The emitted tokens and the completion log come back in
one read at the segment's end, and the segment raises if the device's log
differs from the plan. ``decode_steps``, ``decode_dispatches``,
``busy_slot_steps`` and the admission counts are exactly what the JAX
engine counts on the same stream; ``decode_traces`` counts captured graphs
(1 per engine on the card, 0 on the CPU) and ``graph_replays`` the steps
run as replays. The launch counts a capture records are credited once per
replay (``kernels.build.credit``).

**Prefill programs.** As the JAX engine compiles one prefill program per
``(nbatch, bucket)`` key (``_prefill_fns``, counted in ``prefill_traces``),
the port builds one ``_PrefillProgram`` per key: static device buffers for
its tokens, lengths, target slots, ``max_new`` and page rows (one host copy
a dispatch), and one body, ``_prefill_body``: the model's prefill, the
first-token argmax, the scatter into the pools and the slots' ``tok``,
``pos``, ``rem`` and ``plen``. Every write has a fixed shape: padding rows
of an admit batch and page rows past a slot's pages repeat a live row's
indices and bytes (where the JAX engine drops out-of-bounds indices), so
nothing depends on the data's shape. On the card each program is captured
as a CUDA graph when it is built (``warmup()``, or a dispatch of a new key)
in one memory pool per engine, and a dispatch replays it; on the CPU the
body runs as it is. ``warmup(prompt_lens)`` builds the keys the lengths
cover and skips built ones. A capture's warm-up run writes only slot 0 and
one page (the trash page of the kernel pool), which it restores, so a live
engine may be warmed between steps.

**Chunked prefill** (``chunk_threshold``). A prompt longer than the
threshold takes a free slot FIFO but gets no prefill dispatch: it is
seated in the slot's row of ``pbuf`` (``plen``, ``pos`` 0, ``tok`` its
first token, ``rem`` max_new) and fed through the decode segments one
token a step, writing its KV, until the slot emits. Preemption recovery
seats the prompt plus the tokens already generated the same way
(``_seat_prefix``).

**In-segment admission** (``stage_slots``). The engine keeps up to
``stage_slots`` pending requests in a device staging ring (prompt rows,
prompt lengths, ``max_new`` and block-table rows whose first
``decode_block`` positions are covered at staging time, under an allocator
ticket). When a slot finishes inside a segment, the step logs it
(slot, step, admitted) in the completion log and, FIFO over the ring,
seats the next staged request in the slot in place: ``tok``, ``pbuf``,
``pos`` 0, ``rem``, ``plen`` and the slot's block-table row, which the
very next step's fused decode reads. ``n_stage`` 0 disables refill, so
one body (and one graph) serves every ``stage_slots``. The host writes the
ring only when the staged FIFO changed, and harvests a segment by the log:
each record closes the slot's occupant over its slice of ``out`` and
promotes the staged request into the slot (its ticket re-keyed to the
slot).

**Optimistic admission and preemption** (``admission="optimistic"``,
``preempt_policy``). Requests are admitted on expected usage (a prefill
needs its prompt pages, a chunked or staged request its first
``decode_block`` stride) and the decode tail grows lazily. When the pool
is dry at a segment's growth point, the engine un-stages the newest staged
request first, then preempts a live victim — the most slack under
``slack`` (no-SLO requests have infinite slack), the most recently
admitted under ``lru`` — frees its pages and parks it with its prompt and
the tokens generated so far. Parked requests re-admit first, once their
whole worst case fits in free pages, by teacher-forcing that prefix
through the decode segments. ``stream=True`` hands out each request's new
tokens at every harvest (``drain_partial_outputs``), once each across a
preemption; ``cancel``/``cancel_overdue`` cut requests short.

Chunked, staged and optimistic admission restart a slot from an empty
decode state. The audio and vlm families need encoder KV from prefill and
per-slot state rows, and the moe family's expert capacity depends on the
co-batched tokens, so, as in the JAX engine, they clamp
``chunk_threshold`` to None, ``stage_slots`` to 0 and ``admission`` to
worst-case, and cannot be preempted or speculate. The moe family also
admits one prompt per prefill dispatch (``_group_admit``): its prefill
programs are of ``nbatch`` 1 only.

**Kernel pool layout.** With ``attention_impl="cuda"`` every pool carries
one extra *trash* page at index ``n_pages``, the block table's sentinel: the
fused decode kernel has no write suppression, so inactive slots write
there, and prefill rows past a slot's pages land there too; the paged
decode kernel's clamped sentinel reads land there as well. The plain path
keeps the exact-size pool and drops those writes instead. Either way no
write touches a live page.

**Prefix cache** (``prefix_cache``, ``prefix_evict``; dense, paged).
Prompts are hashed a page at a time with a chained sha1 (``PrefixCache``);
a prompt page fully written by a slot is registered at the harvest that
passes it, and stays indexed while held and, once released, in the
allocator's cached pool until a dry free list evicts it (LRU or FIFO).
Admission attaches the longest indexed run of a new prompt's pages to its
slot (refcounted) and seats it to feed from the first uncached token
(``_seat_prefix(start=)``). A hit covering the whole prompt still writes
its last position: that page is copied on write first (``_copy_page``, a
device page copy at the host boundary, outside the graph) unless the slot
is its only holder. The step graph writes only at each slot's ``pos``
through ``_bt_dev``, so no write lands in a page of refcount above 1.

**Host swap** (``swap="host"``, ``swap_budget_bytes``; dense, paged). A
preempted request past its prompt feed has its pages copied to plain host
tensors before they are released; at re-admission fresh pages take the
bytes back and ``tok``, ``pos``, ``rem`` and ``plen`` are written in place
(``_swap_in``), so it resumes with no replay. A victim the gates refuse —
the contiguous layout, a slot still feeding, a payload past the budget —
recomputes and counts ``swap_fallbacks``.

**Contiguous layout** (``page_size=None``). Every leaf keeps its
``(.., B, max_len, ..)`` shape and a slot owns its rows: no allocator, no
block table, no ring block-table rows. Prefill writes a slot's rows, and
the decode step writes each slot's k/v at ``pos`` and attends up to
``pos + 1`` (``kvcache.update_layer_cache``; on the card the contiguous
decode kernel's per-slot form, inside the same captured step). Admission
is gated on free slots alone, so optimistic admission clamps to worst
case, and the prefix cache and swap (page mechanisms) are off.

**In place.** Pools and the loop state are updated in place (the JAX
engine is functional). The warm-up steps a capture needs run with every
slot inactive, every block-table row at the sentinel and the ring empty,
so their writes are dropped (in the contiguous layout they land on rows
no slot has read yet, ``_quiesced``), and the loop state is restored
afterwards.

**Hybrid family** (zamba2). The shared block's k/v are paged like any
attention leaf; the Mamba layers' ``ssm`` and ``conv`` states have no
sequence axis and stay per slot. Every seat of a prefix (chunked
admission, a staged seat at a boundary, preemption recovery, a
speculative re-seat) resets the slot's state rows to the family's empty
state (``Model.empty_state``), and the step body resets, inside the
captured graph, the rows of every slot the ring refills
(``kvcache.reset_slot_rows``, a masked write of fixed shape). Prefill
writes the slot's state rows. Not every leaf is in the pool, so the prefix
cache clamps off and host swap falls back to recompute, as in the JAX
engine.

**SSM family** (xLSTM). Every leaf is a per-slot f32 state with no
sequence axis, so nothing is paged: a page size is inert (``_paged``
false, no allocator) and the engine runs the contiguous path. The empty
state is not zeros (the stabilizers start at -1e30, the sLSTM normalizer
at 1e-6), and the seats and the in-graph refill reset to it as for the
hybrid family. The prefix cache clamps off and host swap falls back.

**Speculative decoding** (``speculate=(draft_model, draft_params)``,
``spec_k``). A round replaces a decode segment when every live slot is
past its seated prefix and ``spec_k`` positions short of its span: the
dense draft (``_DraftRunner``, its own contiguous cache) proposes
``spec_k`` greedy tokens a slot, the target verifies the window
``[tok, d_0 .. d_{k-1}]`` at ``pos .. pos + k`` and takes its own argmax
at each position, and the host accepts the longest matching prefix plus
the target's next token, so the stream is plain greedy decode's. The
dense target verifies in one ``decode_window`` forward; the hybrid and
ssm targets in ``spec_k + 1`` single-token decodes, and a slot whose
window was not all accepted is re-seated through the teacher-forced
replay (its state advanced through rejected feeds). On the card the
propose, the verify and each draft resync bucket are captured CUDA graphs
(``warmup()``), over static buffers: the host writes the round's
``tok``/``pos`` in one copy, reads the drafts and the target's argmaxes
in one read, runs the accept loop and writes ``tok``, ``pos`` and ``rem`` back in one copy. A
speculating target attends in plain PyTorch: the verify window runs
outside the fused decode kernel, so ``attention_impl="cuda"`` raises
(``ArchConfig.for_device(dev, speculate=True)`` builds the target; its
int8 projections keep the int8 kernel), as the JAX engine refuses Pallas
attention. Staging is off while speculating, as in the JAX engine.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import (Any, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.models import kvcache as KV
from repro_torch.models.model import Model
from repro_torch.models.transformer import DTYPES


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 8
    arrival: float = 0.0
    tokens: Optional[np.ndarray] = None
    latency: float = 0.0
    # wall time the request entered a slot (prefill, chunked seat, or
    # in-segment promotion at harvest); admitted - arrival is queue delay
    admitted: float = -1.0
    # latency objective in seconds (deadline = arrival + slo); None is
    # best-effort. The slack policy picks victims by it.
    slo: Optional[float] = None
    # times this request was preempted (pages freed, parked, replayed)
    preemptions: int = 0
    # streaming cursor: tokens [0, streamed) were handed out already; it
    # survives a preemption, so a replay never re-streams them
    streamed: int = 0
    # wall time of the harvest that first handed out a token; -1 until then
    first_token: float = -1.0
    # set by ``cancel``: ``tokens`` holds only what was generated by then
    cancelled: bool = False


@dataclasses.dataclass
class _Parked:
    """A preempted request parked on the host awaiting re-admission."""
    req: Request
    prefix: np.ndarray      # prompt + every token generated before preempt
    done: List[int]         # tokens already generated (re-credited at seat)
    # host swap payload (``swap="host"``): paged leaf name -> a host copy
    # of the victim's pages in block-table order; None = recompute
    kv: Optional[Dict[str, torch.Tensor]] = None
    swap_bytes: int = 0     # budget charge, released at swap-in or cancel


def bucket_len(n: int, minimum: int = 8, maximum: Optional[int] = None) -> int:
    """Round ``n`` up to a power of two >= ``minimum`` (clamped to maximum)."""
    b = max(minimum, 1 << max(int(n) - 1, 0).bit_length())
    if maximum is not None:
        if n > maximum:
            raise ValueError(f"length {n} exceeds engine max_len {maximum}")
        b = min(b, maximum)
    return b


class PageAllocator:
    """Host-side accounting for the shared KV page pool.

    Admission reserves a holder's worst case so that ``cover()`` — which
    hands out physical pages lazily as the holder's position grows —
    always succeeds within the reservation. Holders are arbitrary keys:
    live slots by slot index, staged requests by ``("stage", n)`` tickets,
    re-keyed to the slot that the staging ring promotes them into
    (``rekey``). Optimistic admission reserves with ``strict=False`` (the
    commitments may exceed the pool) and probes growth with
    ``can_cover``.

    **Sharing** (the prefix cache): pages are refcounted. ``attach()``
    points another holder at pages already resident, ``release()``
    decrements, and a page whose count reaches 0 goes to the free list or,
    when the ``retain`` hook claims it (the prefix cache keeps the pages it
    has indexed), to a *cached* pool of reclaimable pages. ``cover()`` and
    ``cow()`` evict a cached page (``evict_choice`` picks it, ``on_evict``
    tells the index) when the free list is dry, so caching never costs
    capacity. Invariants: free + cached + unique held pages == ``n_pages``,
    a page's refcount equals the number of holders listing it, eviction
    takes only pages of refcount 0, and a full drain returns every page to
    the free or the cached pool.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool: {n_pages} pages x {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))[::-1]
        self._pages: Dict[Any, List[int]] = {}
        self._reserved: Dict[Any, int] = {}
        self._refcnt: Dict[int, int] = {}          # page -> holders
        self._cached: Dict[int, None] = {}         # retained, refcount 0
        # the prefix cache's seams (all optional): ``retain(page) -> bool``
        # keeps a released page cached instead of free; ``evict_choice()
        # -> page`` picks the cached page to reclaim; ``on_evict(page)``
        # tells the index its contents are about to be overwritten
        self.retain = None
        self.evict_choice = None
        self.on_evict = None
        self.evictions = 0

    def pages_needed(self, n_positions: int) -> int:
        return max(0, -(-int(n_positions) // self.page_size))

    @property
    def committed(self) -> int:
        """Pages promised to holders (held now or claimable later)."""
        return sum(self._reserved.values())

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Pages of refcount 0 the prefix cache retains (reclaimable)."""
        return len(self._cached)

    @property
    def n_avail(self) -> int:
        """Pages a cover or a cow can obtain: free + evictable."""
        return len(self._free) + len(self._cached)

    def refcount(self, page: int) -> int:
        return self._refcnt.get(page, 0)

    def live_pages(self) -> List[int]:
        return [p for pages in self._pages.values() for p in pages]

    def pages_of(self, holder: Any) -> List[int]:
        return list(self._pages.get(holder, ()))

    def can_reserve(self, n_positions: int) -> bool:
        return self.committed + self.pages_needed(n_positions) <= self.n_pages

    def reserve(self, holder: Any, n_positions: int,
                strict: bool = True) -> None:
        """Admit ``holder``: commit its worst-case page count (no pages
        yet). ``strict=False`` skips the over-commit check: optimistic
        admission resolves a dry pool by preemption instead."""
        if holder in self._reserved:
            raise ValueError(f"slot {holder} already live")
        need = self.pages_needed(n_positions)
        if strict and self.committed + need > self.n_pages:
            raise ValueError(f"over-committed: {self.committed}+{need} "
                             f"> {self.n_pages}")
        self._reserved[holder] = need
        self._pages[holder] = []

    def can_cover(self, holder: Any, n_positions: int) -> bool:
        """Enough obtainable pages for ``cover(holder, n_positions)``?
        Always true under worst-case admission; the pressure probe of
        optimistic admission. Cached pages count: they evict on demand."""
        held = len(self._pages[holder])
        target = min(self.pages_needed(n_positions), self._reserved[holder])
        return target - held <= self.n_avail

    def _grab(self) -> int:
        """One physical page at refcount 1: the free list first, else an
        evicted cached page (refcount 0, so no holder references it)."""
        if self._free:
            page = self._free.pop()
        else:
            page = (self.evict_choice() if self.evict_choice
                    else next(iter(self._cached)))
            del self._cached[page]
            if self.on_evict is not None:
                self.on_evict(page)
            self.evictions += 1
        self._refcnt[page] = 1
        return page

    def _deref(self, page: int) -> None:
        self._refcnt[page] -= 1
        if self._refcnt[page] == 0:
            del self._refcnt[page]
            if self.retain is not None and self.retain(page):
                self._cached[page] = None
            else:
                self._free.append(page)

    def cover(self, holder: Any, n_positions: int) -> List[int]:
        """Grow ``holder`` to cover positions [0, n); returns the new pages."""
        held = self._pages[holder]
        target = min(self.pages_needed(n_positions), self._reserved[holder])
        grown = []
        while len(held) < target:
            page = self._grab()
            grown.append(page)
            held.append(page)
        return grown

    def attach(self, holder: Any, pages: Sequence[int]) -> None:
        """Point ``holder`` at resident pages (a prefix-cache hit): each
        page's refcount grows by one, cached pages come back live, and the
        pages count toward the holder's reservation like covered ones."""
        held = self._pages[holder]
        for p in pages:
            self._cached.pop(p, None)
            self._refcnt[p] = self._refcnt.get(p, 0) + 1
            held.append(p)

    def cow(self, holder: Any, idx: int) -> Tuple[int, int]:
        """Copy-on-write ``holder``'s ``idx``-th page: grab a private page
        at refcount 1, put it in the holder's list and drop the holder's
        reference to the shared one. Returns ``(shared, private)``; the
        caller copies the page's device contents."""
        held = self._pages[holder]
        old = held[idx]
        new = self._grab()
        held[idx] = new
        self._deref(old)
        return old, new

    def release(self, holder: Any) -> List[int]:
        """Drop all of ``holder``'s page references. A page nobody else
        references goes to the free list, or to the cached pool when the
        prefix cache indexes it."""
        pages = self._pages.pop(holder)
        del self._reserved[holder]
        for p in pages:
            self._deref(p)
        return pages

    def rekey(self, old: Any, new: Any) -> None:
        """Move a reservation and its pages to a new holder key: a staged
        request's ticket becomes the slot it was pulled into."""
        if new in self._reserved:
            raise ValueError(f"holder {new!r} already live")
        self._reserved[new] = self._reserved.pop(old)
        self._pages[new] = self._pages.pop(old)


class PrefixCache:
    """Host-side prefix index over the shared KV page pool.

    Prompts are hashed a page at a time with a chained digest,
    ``h_i = sha1(h_{i-1} || tokens[i*ps:(i+1)*ps])``, so a page's digest
    commits to every token before it. ``register()`` maps a digest to the
    physical page holding that page's KV once the page is fully written
    with prompt tokens; ``lookup()`` walks a new prompt's chain and returns
    the longest run of indexed pages, which admission attaches to the new
    slot's block table (refcounted; a seat that must write inside a shared
    page copies it first).

    Indexed pages stay indexed while held and move to the allocator's
    cached pool when their last holder releases them; a cached page is
    evicted (and unindexed, through ``on_evict``) only when the free list
    is dry. ``policy="lru"`` evicts the page released longest ago,
    ``"fifo"`` the one registered first.
    """

    def __init__(self, alloc: PageAllocator, page_size: int,
                 policy: str = "lru"):
        if policy not in ("lru", "fifo"):
            raise ValueError(f"unknown prefix eviction policy {policy!r}")
        self._alloc = alloc
        self.page_size = page_size
        self.policy = policy
        self._index: Dict[bytes, int] = {}       # chain digest -> page
        self._hash_of: Dict[int, bytes] = {}     # page -> chain digest
        self._reg_seq: Dict[int, int] = {}       # page -> registration no.
        self._seq = 0
        alloc.retain = self._retain
        alloc.on_evict = self._on_evict
        alloc.evict_choice = self._evict_choice

    def _retain(self, page: int) -> bool:
        return page in self._hash_of

    def _on_evict(self, page: int) -> None:
        h = self._hash_of.pop(page)
        del self._index[h]
        del self._reg_seq[page]

    def _evict_choice(self) -> int:
        cached = self._alloc._cached
        if self.policy == "fifo":
            return min(cached, key=lambda p: self._reg_seq[p])
        return next(iter(cached))       # dict order is release order

    def chain(self, tokens: np.ndarray) -> List[bytes]:
        """Chained digests of every *full* page of ``tokens``."""
        ps = self.page_size
        toks = np.ascontiguousarray(np.asarray(tokens), np.int32)
        h, out = b"", []
        for i in range(len(toks) // ps):
            h = hashlib.sha1(h + toks[i * ps:(i + 1) * ps].tobytes()).digest()
            out.append(h)
        return out

    def lookup(self, tokens: np.ndarray) -> List[int]:
        """The longest indexed page run covering a prefix of ``tokens``."""
        pages = []
        for h in self.chain(tokens):
            page = self._index.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def register(self, digests: Sequence[bytes],
                 pages: Sequence[int]) -> None:
        """Index ``pages[i]``, fully written with the tokens ``digests[i]``
        commits to. A digest already indexed keeps its first page: two
        slots that raced the same prompt each keep their own copy."""
        for h, p in zip(digests, pages):
            if h in self._index or p in self._hash_of:
                continue
            self._index[h] = p
            self._hash_of[p] = h
            self._reg_seq[p] = self._seq
            self._seq += 1

    def unindex(self, page: int) -> None:
        """Drop ``page`` from the index: its sole holder is about to write
        it in place. It registers again (same digest, same contents) once
        the holder's writes are harvested."""
        h = self._hash_of.pop(page, None)
        if h is not None:
            del self._index[h]
            del self._reg_seq[page]

    def __len__(self) -> int:
        return len(self._index)


class SegmentPlan(NamedTuple):
    """What one decode segment does, from host mirrors alone."""
    n_steps: int
    busy: int                   # active slot-steps
    log: np.ndarray             # (n, 3) int32 completions: slot, step, adm
    emits: np.ndarray           # (B, n_steps) bool: slot emitted at step
    rem: np.ndarray             # loop state after the segment
    pos: np.ndarray
    plen: np.ndarray


def plan_segment(rem: np.ndarray, pos: np.ndarray, plen: np.ndarray,
                 ring: Sequence[Tuple[int, int]],
                 max_steps: int) -> SegmentPlan:
    """The step body's bookkeeping, run on the host: up to ``max_steps``
    steps while some slot is active, with ``ring`` the staged requests'
    ``(prompt_len, max_new)`` in FIFO order. A step advances every active
    slot (``rem > 0``), emits where it no longer feeds a prompt
    (``pos + 1 >= plen``), finishes a slot whose ``rem`` reaches 0 and
    refills finished slots, in slot order, from the ring's next entries.
    The device runs the same arithmetic, so the plan sets the number of
    graph replays and predicts the completion log exactly."""
    rem, pos, plen = (np.array(a, np.int64) for a in (rem, pos, plen))
    head, busy, i = 0, 0, 0
    log, emits = [], []
    while i < max_steps and (rem > 0).any():
        active = rem > 0
        emit = active & ~(pos + 1 < plen)
        pos += active
        rem -= emit
        for s in np.flatnonzero(emit & (rem == 0)):
            adm = head < len(ring)
            log.append((s, i, int(adm)))
            if adm:
                plen[s], rem[s] = ring[head]
                pos[s] = 0
                head += 1
        busy += int(active.sum())
        emits.append(emit)
        i += 1
    return SegmentPlan(
        i, busy, np.asarray(log, np.int32).reshape(-1, 3),
        np.stack(emits, 1) if emits else np.zeros((len(rem), 0), bool),
        rem, pos, plen)


# warm-up runs of the step body before its capture (the side-stream
# iterations ``torch.cuda.graphs`` asks for)
WARM_STEPS = 3

# one graph capture at a time in the process: the caching allocator routes
# a capture's allocations by the capturing stream, and emptying its cache
# (which each capture does first) asserts while another capture is under
# way
_CAPTURE_LOCK = threading.Lock()


_thread = threading.local()


def side_stream(device: torch.device):
    """This thread's side stream for graph warm-ups and captures, made
    once: the libraries keep per-stream state (cuBLAS a workspace per
    handle and stream), so a new stream per capture would leave a
    workspace behind each time."""
    stream = getattr(_thread, "stream", None)
    if stream is None:
        stream = _thread.stream = torch.cuda.Stream(device)
    return stream


def capture_graph(device: torch.device, body, pool=None):
    """Capture ``body()`` as a CUDA graph on this thread's side stream, in
    ``thread_local`` mode (other threads' syncs and launches go on), under
    the process's capture lock, in memory pool ``pool`` (a private one by
    default). Returns ``(graph, launches)``: the wrapper launches counted
    on this thread while it recorded (``kernels.build.capturing``). The
    caller has run the body on this engine's buffers first (the warm-up a
    capture needs).

    Garbage is collected and the allocator's cached blocks released first,
    as ``torch.cuda.graph`` does, and the cyclic collector is off while the
    capture records: a graph or engine freed by a collection mid-capture
    (an engine that holds speculative programs is a reference cycle)
    destroys its graph, which invalidates the capture under way; and a
    capture allocates from its pool alone and cannot free cached memory,
    so memory cached outside the pool (a model's init temporaries, the
    warm-up's activations) would otherwise leave it none."""
    with _CAPTURE_LOCK:
        gc.collect()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        side = side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with build.capturing() as launches, torch.no_grad(), \
                    torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    body()
                finally:
                    graph.capture_end()
        finally:
            if was_enabled:
                gc.enable()
        torch.cuda.current_stream(device).wait_stream(side)
    return graph, launches


class _PrefillProgram:
    """One ``(nbatch, bucket)`` prefill program of an engine: its inputs
    in one static device buffer that the host refills with one copy a
    dispatch, its first tokens in a static output, the family's stub
    encoder input, and, on the card, the captured graph of
    ``ServingEngine._prefill_body`` over them with the launches it
    recorded (credited per replay).

    Inputs: ``tokens`` (nb, bucket) right-padded, ``lengths`` (nb,),
    ``sel`` (nb,) the live row whose outputs each row writes (padding rows
    repeat row 0), ``slots`` and ``rem`` (nb,) the target slot and
    ``max_new - 1`` of that row, and, paged, ``src``/``dst`` (nb * n_rows,)
    the page row written to each physical page (``scatter_page_rows``)."""

    def __init__(self, eng: "ServingEngine", nb: int, bucket: int):
        self.nb, self.bucket = nb, bucket
        self.n_rows = eng._page_rows_for(bucket) if eng._paged else 0
        nr = nb * self.n_rows
        sizes = [nb * bucket, nb, nb, nb, nb, nr, nr]
        self.host = np.zeros((sum(sizes),), np.int64)
        self.inp = torch.zeros((sum(sizes),), dtype=torch.long,
                               device=eng.device)
        self._host_views = self._views(self.host, sizes)
        (self.tokens, self.lengths, self.sel, self.slots, self.rem,
         self.src, self.dst) = self._views(self.inp, sizes)
        self.firsts = torch.zeros((nb,), dtype=torch.int32,
                                  device=eng.device)
        self.stub = eng._prefill_stub(self)
        self.graph: Optional[Any] = None
        self.launches: Dict[str, int] = {}

    def _views(self, flat, sizes):
        cuts = np.cumsum([0, *sizes])
        out = [flat[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        out[0] = out[0].reshape(self.nb, self.bucket)
        return out

    def load(self, *arrays) -> None:
        """Write the inputs (in the order of the class docstring) into
        the device buffer: one host copy."""
        for view, a in zip(self._host_views, arrays):
            view[...] = a
        self.inp.copy_(torch.from_numpy(self.host))


class _SpecProgram:
    """One captured body of a speculating engine (the draft's propose, a
    draft resync bucket, the target's verify): the body, a context that
    quiesces its warm-up run (restoring what it writes) and, on the card,
    its graph and the launches the capture recorded (credited per
    replay). The engine captures and runs it (``_capture_spec``,
    ``_run_spec``)."""

    def __init__(self, name: str, body, quiesce):
        self.name, self.body, self.quiesce = name, body, quiesce
        self.graph: Optional[Any] = None
        self.launches: Dict[str, int] = {}


@contextmanager
def _restoring(tensors: Sequence[torch.Tensor]) -> Iterator[None]:
    """Inside the block the tensors may be written; they are restored on
    exit (the warm-up run of a capture on a live engine)."""
    saved = [(t, t.clone()) for t in tensors]
    try:
        yield
    finally:
        for t, v in saved:
            t.copy_(v)


class _DraftRunner:
    """The draft model of a speculating engine (``repro``'s
    ``_DraftRunner``).

    The draft is dense and runs greedy decode over its own contiguous
    ``(L, max_batch, max_len, K, D)`` cache, slot for slot with the
    target. ``state[s]`` is ``(occupant, pos)``: the request whose fed
    tokens the draft rows ``[0, pos)`` of slot ``s`` hold. After a round
    the draft is in sync by construction (its accepted rows hold the
    accepted tokens; rows past the rewind point are rewritten before they
    are read), so the marker moves on the host alone; a slot whose target
    advanced without the draft (a decode segment, a seat, a replay) misses
    the marker and is resynced by one bucketed prefill of its fed prefix,
    written into the slot's rows.

    Programs: ``propose`` (one per engine) and one ``resync`` per prompt
    bucket at batch 1, each captured as a CUDA graph on the card over
    static buffers (the engine's round inputs, ``drafts``, the resync
    inputs). Free slots propose from token 0 at position 0 into their own
    rows, which is harmless: every row is rewritten before a masked read
    can include it."""

    def __init__(self, eng: "ServingEngine", model: Model, params: Any,
                 k: int):
        if model.cfg.family != "dense":
            raise ValueError(f"draft model must be dense family, got "
                             f"{model.cfg.family!r}")
        if model.device != eng.device:
            raise ValueError(f"draft on {model.device}, target on "
                             f"{eng.device}")
        self.eng, self.model, self.params, self.k = eng, model, params, k
        B, L = eng.max_batch, eng.max_len
        self.cache = {n: torch.zeros(sh, dtype=dt, device=eng.device)
                      for n, (sh, dt) in model.cache_shapes(B, L).items()}
        self.state: List[Optional[Tuple[Any, int]]] = [None] * B
        self.stats: Dict[str, int] = {"resyncs": 0, "propose_traces": 0,
                                      "resync_traces": 0}
        self._propose: Optional[_SpecProgram] = None
        # resync programs by bucket: the body and its static inputs
        # (tokens (1, bucket), length (1,), slot (1,)) in one buffer
        self._resync: Dict[int, Tuple[_SpecProgram, torch.Tensor]] = {}

    def in_sync(self, slot: int, occupant: Any, pos: int) -> bool:
        st = self.state[slot]
        return st is not None and st[0] is occupant and st[1] == pos

    def _propose_body(self) -> None:
        """``k + 1`` greedy draft steps of every slot from the round's
        ``tok`` at ``pos``; the first ``k`` argmaxes go to ``drafts``.

        The last step emits nothing but writes the KV row of the last
        proposal. Without it a fully accepted window leaves the draft
        cache one row short of the marker the engine sets (the verify fed
        the last proposal into the *target* cache, so the stream moves
        past it), and the stale row quietly lowers every later round's
        acceptance, most where the slot's previous occupant left real KV
        there."""
        eng = self.eng
        tok, pos = eng._spec_tok, eng._spec_pos
        for i in range(self.k + 1):
            logits, _ = self.model.decode(self.params, self.cache, tok, pos)
            if i < self.k:
                nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                eng._drafts[:, i].copy_(nxt)
                tok = nxt[:, None]
            pos = pos + 1

    def propose_program(self) -> _SpecProgram:
        if self._propose is None:
            self._propose = _SpecProgram(
                "the draft's propose", self._propose_body,
                lambda: _restoring(list(self.cache.values())))
            self.stats["propose_traces"] += 1
            self.eng._capture_spec(self._propose)
        return self._propose

    def resync_program(self, bucket: int):
        """The resync program of ``bucket``, built (and on the card
        captured) once: the draft's prefill of one right-padded prefix,
        its rows [0, bucket) written into the slot's rows of every leaf
        (``index_copy_`` on the batch axis at a device slot index: no
        host sync)."""
        entry = self._resync.get(bucket)
        if entry is None:
            inp = torch.zeros((bucket + 2,), dtype=torch.long,
                              device=self.eng.device)
            tokens, length, slot = (inp[:bucket].view(1, bucket),
                                    inp[bucket:bucket + 1], inp[bucket + 1:])

            def body():
                _, pc = self.model.prefill(
                    self.params, {"tokens": tokens, "length": length})
                for name, leaf in self.cache.items():
                    leaf.narrow(2, 0, bucket).index_copy_(
                        1, slot, pc[name].to(leaf.dtype))

            def quiesce():
                # the warm-up writes slot 0's rows: restore them
                return _restoring([leaf.select(1, 0)
                                   for leaf in self.cache.values()])

            prog = _SpecProgram(f"the draft's resync at bucket {bucket}",
                                body, quiesce)
            self.stats["resync_traces"] += 1
            self.eng._capture_spec(prog)
            entry = self._resync[bucket] = (prog, inp)
        return entry

    def resync(self, slot: int, full: np.ndarray, pos: int) -> None:
        """Rebuild the draft rows ``[0, pos)`` of ``slot`` from the
        occupant's fed prefix ``full`` (rows past ``pos`` take the
        padding's KV, which is rewritten before it is read)."""
        if pos <= 0:
            return
        bucket = bucket_len(pos, self.eng.min_bucket, self.eng.max_len)
        prog, inp = self.resync_program(bucket)
        host = np.zeros((bucket + 2,), np.int64)
        host[:pos] = full[:pos]
        host[bucket], host[bucket + 1] = pos, slot
        inp.copy_(torch.from_numpy(host))
        self.eng._run_spec(prog)
        self.stats["resyncs"] += 1


class ServingEngine:
    """Continuous-batching engine over one model + params (greedy decode)."""

    def __init__(self, model: Model, params: Any, max_batch: int = 8,
                 max_len: int = 128, decode_block: int = 16,
                 min_bucket: int = 8, page_size: Optional[int] = 16,
                 n_pages: Optional[int] = None,
                 chunk_threshold: Optional[int] = None,
                 stage_slots: int = 0, admission: str = "worstcase",
                 preempt_policy: str = "slack",
                 prefix_cache: bool = False, prefix_evict: str = "lru",
                 swap: Optional[str] = None,
                 swap_budget_bytes: Optional[int] = None,
                 speculate: Optional[Tuple[Model, Any]] = None,
                 spec_k: int = 4, stream: bool = False):
        if admission not in ("worstcase", "optimistic"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if preempt_policy not in ("slack", "lru"):
            raise ValueError(f"unknown preempt policy {preempt_policy!r}")
        if swap not in (None, "host"):
            raise ValueError(f"unknown swap mode {swap!r}")
        if page_size is not None and max_len % page_size != 0:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        cfg = model.cfg
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.decode_block = decode_block
        self.min_bucket = min_bucket
        self.stream = bool(stream)
        # MoE expert capacity is a function of the co-batched token count,
        # so a grouped admit could change which tokens are dropped against
        # a serial run: moe prompts are admitted one per dispatch
        self._group_admit = cfg.family != "moe"
        # chunked prefill, the staging ring and preemption recovery restart
        # a slot from the family's empty decode state (the hybrid family's
        # zero state rows, xLSTM's -1e30 stabilizers); the audio and vlm
        # families need encoder KV from prefill and admit whole prompts,
        # and moe stays out because feeding prompt tokens inside the shared
        # decode batch would change its capacity drops against the solo
        # prefill, as in the JAX engine
        self._chunk_ok = cfg.family in ("dense", "hybrid", "ssm")
        self.chunk_threshold = chunk_threshold if self._chunk_ok else None
        self.stage_slots = int(stage_slots) if self._chunk_ok else 0
        # speculative decoding: the checks of the JAX engine, in its order
        self.spec_k = int(spec_k)
        self._spec: Optional[_DraftRunner] = None
        self._verify: Optional[_SpecProgram] = None
        if speculate is not None:
            draft_model, draft_params = speculate
            if not self._chunk_ok:
                raise ValueError(
                    f"family {cfg.family!r} cannot speculate: mismatch "
                    "rollback needs the teacher-forced replay path (dense, "
                    "hybrid and ssm)")
            if cfg.attention_impl == "cuda":
                raise ValueError(
                    "speculative decoding needs attention_impl='torch': the "
                    "verify window runs outside the fused CUDA decode "
                    "kernel, so bit-identity with plain decode would not "
                    "hold (build the target with ArchConfig.for_device(dev,"
                    " speculate=True))")
            if draft_model.cfg.vocab != cfg.vocab:
                raise ValueError(f"draft vocab {draft_model.cfg.vocab} != "
                                 f"target vocab {cfg.vocab}")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            # a round has no segment to refill a slot in: admission stays
            # at step boundaries while speculating
            self.stage_slots = 0
        self.preempt_policy = preempt_policy
        self.page_size = page_size
        shapes = model.cache_shapes(max_batch, max_len, enc_len=max_len)
        self._axes = KV.leaf_axes(model.cache_shapes, max_len)
        # a page size pages the leaves with a sequence axis; None is the
        # contiguous layout, and so is a family with no such leaf (xLSTM's
        # O(1) states), whatever the knob says
        self._paged = page_size is not None and any(
            sax != -1 for _, sax in self._axes.values())
        # every leaf position-addressable (no per-slot state): the gate of
        # the prefix cache and of host swap, which rebuild a slot from pool
        # pages alone
        self._all_paged = all(sax != -1 for _, sax in self._axes.values())
        # per-slot state leaves that a seat or a refill resets to the
        # family's empty state (the hybrid family's ssm and conv rows), and
        # each one's empty row, batch axis leading; the audio and vlm state
        # leaves are written by prefill alone
        self._reset_rows: Dict[str, torch.Tensor] = {}
        if self._chunk_ok:
            empty = model.empty_state(1, max_len, enc_len=max_len)
            self._reset_rows = {
                n: empty[n].movedim(bax, 0).contiguous()
                for n, (bax, sax) in self._axes.items() if sax == -1}
        self._cache = {}
        if self._paged:
            self.pages_per_slot = max_len // page_size
            self.n_pages = (max_batch * self.pages_per_slot
                            if n_pages is None else n_pages)
            self._alloc: Optional[PageAllocator] = PageAllocator(
                self.n_pages, page_size)
            # the fused kernel writes inactive slots' rows into a trash
            # page at the sentinel index; the plain path drops those writes
            self._pool_pages = self.n_pages + (
                1 if cfg.attention_impl == "cuda" else 0)
            for name, (dims, dtype) in shapes.items():
                bax, sax = self._axes[name]
                if sax != -1:
                    dims = KV.pool_shape(dims, bax, sax, self._pool_pages,
                                         page_size)
                self._cache[name] = torch.zeros(dims, dtype=dtype,
                                                device=self.device)
            # the block table: a host copy that admission and growth edit,
            # and its static device buffer, refreshed in place before a
            # segment
            self._bt = KV.sentinel_block_table(
                max_batch, self.pages_per_slot, self.n_pages)
            self._bt_dev = torch.from_numpy(self._bt).to(self.device)
        else:
            # the contiguous layout: every leaf keeps its (.., B, max_len,
            # ..) shape and a slot owns its rows; no allocator, no table
            self.pages_per_slot = self.n_pages = self._pool_pages = 0
            self._alloc = None
            self._bt = self._bt_dev = None
            for name, (dims, dtype) in shapes.items():
                self._cache[name] = torch.zeros(dims, dtype=dtype,
                                                device=self.device)
        self._bt_stale = False
        # optimistic admission is a page-pool discipline: the contiguous
        # layout (and the families that cannot replay) clamp it off
        self.admission = admission if (self._paged and self._chunk_ok) \
            else "worstcase"
        # the prefix cache needs the paged layout, the teacher-forced seat
        # (a hit resumes the prompt at its first uncached token) and every
        # leaf in the pool: audio's enc_len and vlm's image k/v are
        # per-slot state, so those families (and the contiguous layout)
        # clamp it off
        self._prefix: Optional[PrefixCache] = None
        if prefix_cache and self._paged and self._chunk_ok \
                and self._all_paged:
            self._prefix = PrefixCache(self._alloc, page_size,
                                       policy=prefix_evict)
        # per-slot registration frontier: prompt pages [0, _reg_upto[s])
        # of slot s are indexed; the chain digests of its seated row are
        # taken at seat time
        self._reg_upto = np.zeros((max_batch,), np.int64)
        self._seat_digests: List[List[bytes]] = [[] for _ in
                                                 range(max_batch)]
        # host swap: a victim's pages copied to host memory at preemption
        # and scattered back at re-admission, bounded by the budget (None
        # = unbounded); whatever the gates refuse recomputes
        self.swap = swap
        self.swap_budget_bytes = swap_budget_bytes
        self._swap_live_bytes = 0
        # the decode loop state (the reference's carry), static buffers
        # that a captured step reads and writes at fixed addresses
        i32 = dict(dtype=torch.int32, device=self.device)
        # tok, pos and rem: views of one buffer, which a speculative round
        # writes back in one copy
        self._tpr = torch.zeros((3 * max_batch,), **i32)
        self._tok = self._tpr[:max_batch].view(max_batch, 1)
        self._pos = self._tpr[max_batch:2 * max_batch]
        self._rem_dev = self._tpr[2 * max_batch:]
        self._plen_dev = torch.zeros((max_batch,), **i32)
        self._pbuf = torch.zeros((max_batch, max_len), **i32)
        self._step_i = torch.zeros((1,), dtype=torch.long,
                                   device=self.device)
        self._slot_ids = torch.arange(max_batch, **i32)
        # the staging ring, one buffer written by one host copy: prompt
        # rows (R, max_len), prompt lengths and max_new (R,), block-table
        # rows (R, pages_per_slot; none in the contiguous layout) and the
        # count of valid entries
        R = self._ring_cap = max(self.stage_slots, 1)
        pps = self.pages_per_slot
        self._ring_host = np.zeros((R * (max_len + 2 + pps) + 1,), np.int32)
        self._ring = torch.zeros(self._ring_host.shape, **i32)
        (self._ring_tok, self._ring_plen, self._ring_new, self._ring_bt,
         self._n_stage) = self._ring_views(self._ring)
        self._ring_stale = True
        # what a segment hands back, one buffer read by one host copy: the
        # emitted tokens (B, decode_block), the completion log (slot, step,
        # admitted) with room for every slot and ring entry plus the trash
        # entry that non-finishing slots write, and the counters n_comp,
        # busy and the ring head
        self._max_comps = max_batch + R
        C = self._max_comps + 1
        self._rb = torch.zeros((max_batch * decode_block + 3 * C + 3,), **i32)
        nb = max_batch * decode_block
        self._out = self._rb[:nb].view(max_batch, decode_block)
        self._comp_slot, self._comp_step, self._comp_adm = (
            self._rb[nb + k * C:nb + (k + 1) * C] for k in range(3))
        self._counters = self._rb[nb + 3 * C:]
        self._n_comp, self._busy, self._head = (
            self._counters[k:k + 1] for k in range(3))
        self._dcache = (dict(self._cache, bt=self._bt_dev) if self._paged
                        else dict(self._cache))
        self._graph: Optional[Any] = None
        self._graph_launches: Dict[str, int] = {}
        # the prefill programs by (nbatch, bucket), the memory pool their
        # graphs share on the card, and the vlm stub input they view
        self._prefill_fns: Dict[Tuple[int, int], _PrefillProgram] = {}
        self._prefill_pool: Optional[Any] = None
        self._image_stub: Optional[torch.Tensor] = None
        # host mirrors of rem, pos and plen: they plan each segment and
        # split its emitted tokens between the slots
        self._rem = np.zeros((max_batch,), np.int64)
        self._slot_pos = np.zeros((max_batch,), np.int64)
        self._plen = np.zeros((max_batch,), np.int64)
        self.stats: Dict[str, int] = {
            "prefill_traces": 0, "prefill_replays": 0,
            "decode_traces": 0, "prefill_dispatches": 0,
            "decode_dispatches": 0, "decode_steps": 0,
            "tokens_generated": 0, "admitted": 0, "chunk_admits": 0,
            "peak_concurrency": 0, "staged": 0, "inseg_admissions": 0,
            "busy_slot_steps": 0, "bubble_slot_steps": 0,
            "preemptions": 0, "preempt_readmits": 0, "pressure_stalls": 0,
            "prefix_hits": 0, "prefix_pages_reused": 0, "cow_copies": 0,
            "evictions": 0, "prefix_tokens_skipped": 0,
            "swap_out": 0, "swap_in": 0, "swap_fallbacks": 0,
            "swap_bytes": 0, "graph_replays": 0,
            "spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0,
            "verify_traces": 0,
        }
        # host wall seconds spent in prefill dispatches, decode segments
        # and speculative rounds (propose and verify), each ending in its
        # host sync, and in the graph replay calls of the segments (their
        # enqueue alone)
        self.timing: Dict[str, float] = {"prefill_s": 0.0, "decode_s": 0.0,
                                         "replay_s": 0.0, "spec_s": 0.0}
        self._pending: deque = deque()
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._gen: Dict[int, List[int]] = {}
        self._free: List[int] = list(range(max_batch))[::-1]
        self._completed: List[Request] = []
        # each slot's seated token row (prompt, or replay prefix) and how
        # many of its _gen entries that row already holds (re-credits)
        self._slot_prefix: List[Optional[np.ndarray]] = [None] * max_batch
        self._seat_credit = np.zeros((max_batch,), np.int64)
        # the staged FIFO (request, allocator ticket, block-table row; the
        # last two None in the contiguous layout), mirrored into the ring
        self._staged: deque = deque()
        self._stage_seq = 0
        # preempted requests parked on the host (``_Parked``), FIFO
        self._preempted: deque = deque()
        # EWMA of a decode step's wall time: the slack policy's estimate
        # of a request's remaining service time
        self._step_est = 0.0
        self._partial: List[Tuple[Request, List[int], float]] = []
        if speculate is not None:
            # a round's inputs (tok (B, 1), pos (B,)) in one buffer written
            # by one host copy, and its outputs (the drafts (B, k), the
            # target's argmaxes (B, k + 1)) in one buffer read by one copy
            B, k = max_batch, self.spec_k
            self._spec_in = torch.zeros((2 * B,), **i32)
            self._spec_tok = self._spec_in[:B].view(B, 1)
            self._spec_pos = self._spec_in[B:]
            self._spec_out = torch.zeros((B * (2 * k + 1),), **i32)
            self._drafts = self._spec_out[:B * k].view(B, k)
            self._preds = self._spec_out[B * k:].view(B, k + 1)
            self._spec_pool: Optional[Any] = None
            self._spec = _DraftRunner(self, draft_model, draft_params, k)

    def _ring_views(self, ring):
        """(ring_tok, ring_plen, ring_new, ring_bt, n_stage) views of a
        flat ring buffer (device tensor or host array)."""
        R, L, P = self._ring_cap, self.max_len, self.pages_per_slot
        cuts = np.cumsum([R * L, R, R, R * P])
        return (ring[:cuts[0]].reshape(R, L), ring[cuts[0]:cuts[1]],
                ring[cuts[1]:cuts[2]], ring[cuts[2]:cuts[3]].reshape(R, P),
                ring[cuts[3]:])

    def _n_positions(self, r: Request) -> int:
        """KV positions a request writes: the prompt plus one per generated
        token except the last (never fed back)."""
        return len(r.prompt) + max(r.max_new_tokens, 1) - 1

    def _sync_bt(self) -> None:
        """Copy the host block table into its device buffer after a change."""
        if self._bt_stale and self._paged:
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_stale = False

    def _sync_ring(self) -> None:
        """Write the staged FIFO into the device ring after a change."""
        if not self._ring_stale:
            return
        h = self._ring_host
        h[:] = 0
        tok, plen, new, bt, n_stage = self._ring_views(h)
        bt[:] = self.n_pages
        for j, (r, _ticket, bt_row) in enumerate(self._staged):
            tok[j, :len(r.prompt)] = r.prompt
            plen[j] = len(r.prompt)
            new[j] = max(r.max_new_tokens, 1)
            if bt_row is not None:
                bt[j] = bt_row
        n_stage[0] = len(self._staged)
        self._ring.copy_(torch.from_numpy(h))
        self._ring_stale = False

    # ------------------------------------------------------------------
    # the decode step: one body, captured on the card
    def _step_body(self) -> None:
        """One decode step of every slot on the device loop state, in
        place: the JAX engine's segment body, staging ring and completion
        log included. The captured graph on the card, the segment loop's
        body on the CPU. Only ops that need no host sync, with no Python
        scalar in ``torch.where``."""
        tok, pos, rem, plen = self._tok, self._pos, self._rem_dev, \
            self._plen_dev
        active = rem > 0
        logits, _ = self.model.decode(self.params, self._dcache, tok, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        # chunked prefill: while prompt tokens remain, feed the next one
        # instead of the sampled token and emit nothing
        feeding = pos + 1 < plen
        at = torch.clamp(pos.long() + 1, 0, self.max_len - 1)
        nxt = torch.where(feeding, torch.gather(self._pbuf, 1, at[:, None])
                          [:, 0], nxt)
        emits = active & ~feeding
        self._out.index_copy_(1, self._step_i,
                              nxt.masked_fill(~emits, -1)[:, None])
        tok.copy_(torch.where(active[:, None], nxt[:, None], tok))
        pos.copy_(torch.where(active, pos + 1, pos))
        rem.copy_(torch.where(emits, rem - 1, rem))
        # completion log and in-segment refill: the slots that finished
        # this step are logged (slot, step, admitted) in slot order, and
        # the first ``n_stage - head`` of them take the next ring entries
        fin = emits & (rem == 0)
        fin_i = fin.to(torch.int32)
        nfin = torch.sum(fin_i, dtype=torch.int32)
        rank = torch.cumsum(fin_i, 0, dtype=torch.int32) - 1
        avail = self._n_stage - self._head
        adm = fin & (rank < avail)
        src = torch.clamp(self._head + rank, 0, self._ring_cap - 1).long()
        at_log = (self._n_comp + rank).masked_fill(~fin, self._max_comps)
        at_log = at_log.long()
        step = self._step_i.to(torch.int32).expand(self.max_batch)
        self._comp_slot.index_copy_(0, at_log, self._slot_ids)
        self._comp_step.index_copy_(0, at_log, step.contiguous())
        self._comp_adm.index_copy_(0, at_log, adm.to(torch.int32))
        rows = self._ring_tok.index_select(0, src)
        tok.copy_(torch.where(adm[:, None], rows[:, :1], tok))
        self._pbuf.copy_(torch.where(adm[:, None], rows, self._pbuf))
        pos.masked_fill_(adm, 0)
        rem.copy_(torch.where(adm, self._ring_new.index_select(0, src), rem))
        plen.copy_(torch.where(adm, self._ring_plen.index_select(0, src),
                               plen))
        # the refilled slot's block-table row, read by the next step (the
        # layout is fixed at construction; the contiguous one has no table)
        if self._paged:
            self._bt_dev.copy_(torch.where(
                adm[:, None], self._ring_bt.index_select(0, src),
                self._bt_dev))
        # a refilled slot restarts from the family's empty state
        for name, row in self._reset_rows.items():
            KV.reset_slot_rows(self._cache[name], self._axes[name][0], adm,
                               row)
        self._head.add_(torch.minimum(nfin, avail.clamp(min=0)))
        self._n_comp.add_(nfin)
        self._busy.add_(torch.sum(active.to(torch.int32), dtype=torch.int32))
        self._step_i.add_(1)

    @contextmanager
    def _quiesced(self) -> Iterator[None]:
        """Every slot inactive, every block-table row at the sentinel and
        the ring empty (``n_stage`` 0) inside the block, so a step's KV
        writes are dropped (the plain path) or land on the trash page,
        which the fused kernel drops, and no slot is refilled; ``tok``,
        ``pos``, ``rem``, ``plen``, the prompt buffer, the ring, the
        emitted tokens, the completion log and its counters, the step
        counter and the block table are restored on exit.

        The contiguous layout has no block table to point at a sentinel:
        a step there writes each slot's row at its ``pos``, which no slot
        has read yet (a live slot's rows [0, pos) hold its KV, and the row
        at ``pos`` is the next it writes), so the next write of the
        slot's occupant at that row comes before any read of it. Per-slot
        state rows (the hybrid family's), which every step advances, are
        restored too."""
        saved = [self._tok, self._pos, self._rem_dev, self._plen_dev,
                 self._pbuf, self._ring, self._rb, self._step_i]
        saved += [self._cache[n] for n in self._reset_rows]
        if self._paged:
            saved.append(self._bt_dev)
        with _restoring(saved):
            if self._paged:
                self._bt_dev.fill_(self.n_pages)
            self._rem_dev.zero_()
            self._n_stage.zero_()
            yield

    def _warm_steps(self, n: int = WARM_STEPS) -> None:
        """Run the step body ``n`` times on quiesced state: the warm-up
        that a capture needs, which leaves pools and slot state as they
        were."""
        with self._quiesced(), torch.no_grad():
            for _ in range(n):
                self._step_i.zero_()
                self._step_body()

    def _capture(self) -> None:
        """Capture one step of the body as a CUDA graph, once per engine,
        after warm-up steps on quiesced state (``_warm_steps``) on a side
        stream.

        Raises if the capture fails: no segment runs the eager loop on the
        card."""
        dev = self.device
        side = side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._warm_steps()
        torch.cuda.current_stream(dev).wait_stream(side)
        try:
            graph, launches = capture_graph(dev, self._step_body)
        except Exception as e:
            raise RuntimeError(f"capturing the decode step of "
                               f"{self.model.cfg.name} failed: {e}") from e
        self._graph, self._graph_launches = graph, launches
        self.stats["decode_traces"] += 1

    def _run_steps(self, n_steps: int) -> None:
        """``n_steps`` steps of the body: replays of the captured graph on
        the card, the body itself on the CPU."""
        if self.device.type != "cuda":
            with torch.no_grad():
                for _ in range(n_steps):
                    self._step_body()
            return
        t0 = time.perf_counter()
        for _ in range(n_steps):
            self._graph.replay()
        self.timing["replay_s"] += time.perf_counter() - t0
        build.credit(self._graph_launches, n_steps)
        self.stats["graph_replays"] += n_steps

    # ------------------------------------------------------------------
    def warmup(self, prompt_lens: Sequence[int] = ()) -> None:
        """Build the kernels (on CUDA), the prefill programs of the
        ``(nbatch, bucket)`` keys that ``prompt_lens`` (and the minimum
        bucket) cover, and, on CUDA, capture the decode step.

        As in the JAX engine, a key already built is skipped, so a call on
        covered lengths costs nothing, and prompts that chunked admission
        takes never prefill and are left out. A speculating engine builds
        its verify, propose and resync programs too (``_warm_spec``). On
        the card each new program
        is captured as a graph (``_capture_prefill``), whose warm-up runs
        leave the pools and slot state as they were, so a live engine may
        be warmed between steps."""
        cfg = self.model.cfg
        if cfg.attention_impl == "cuda" or cfg.quantize == "int8_cuda":
            build.build_all()
        lens = [n for n in prompt_lens if self.chunk_threshold is None
                or n <= self.chunk_threshold]
        buckets = {bucket_len(max(n, 1), self.min_bucket, self.max_len)
                   for n in lens + [1]}
        for b in sorted(buckets):
            for nb in sorted({1, self.max_batch} if self._group_admit
                             else {1}):
                self._get_prefill(b, nb)
        if self.device.type == "cuda" and self._graph is None:
            self._capture()
        if self._spec is not None:
            self._warm_spec()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _page_rows_for(self, bucket: int) -> int:
        """Block-table rows a bucket-wide prefill slice spans."""
        return -(-bucket // self.page_size)

    def _grow_slot(self, slot: int, n_positions: int) -> None:
        """Extend ``slot``'s block table to cover positions [0, n)."""
        held = len(self._alloc.pages_of(slot))
        new = self._alloc.cover(slot, n_positions)
        if new:
            self._bt[slot, held:held + len(new)] = new
            self._bt_stale = True

    # ------------------------------------------------------------------
    # prefill: one program per (nbatch, bucket) key, captured on the card
    def _get_prefill(self, bucket: int, nbatch: int) -> _PrefillProgram:
        """The prefill program of key ``(nbatch, bucket)``, built (and on
        the card captured) on first use and counted once in
        ``prefill_traces``, as the JAX engine counts its traces."""
        key = (nbatch, bucket)
        prog = self._prefill_fns.get(key)
        if prog is None:
            prog = _PrefillProgram(self, nbatch, bucket)
            if self.device.type == "cuda":
                self._capture_prefill(prog)
            self._prefill_fns[key] = prog
            self.stats["prefill_traces"] += 1
        return prog

    def _prefill_stub(self, prog: _PrefillProgram) -> Dict[str, Any]:
        """The family's stub encoder input, all zeros as the JAX engine
        feeds it, in static buffers: audio ``frames`` of the bucket's
        width, vlm ``image_embeds`` of ``n_image_tokens`` (one buffer of
        ``max_batch`` rows per engine, a view of ``nbatch`` rows each)."""
        cfg = self.model.cfg
        dtype = DTYPES[cfg.dtype]
        if cfg.family == "audio":
            return {"frames": torch.zeros((prog.nb, prog.bucket, cfg.d_model),
                                          dtype=dtype, device=self.device)}
        if cfg.family == "vlm":
            if self._image_stub is None:
                self._image_stub = torch.zeros(
                    (self.max_batch, cfg.n_image_tokens, cfg.d_model),
                    dtype=dtype, device=self.device)
            return {"image_embeds": self._image_stub[:prog.nb]}
        return {}

    def _prefill_body(self, prog: _PrefillProgram) -> None:
        """One admit dispatch on the device, over the program's static
        buffers, in place: the model's prefill, the first-token argmax
        (into ``prog.firsts``), the scatter of the prompt cache into the
        pools (paged leaves page row by page row) or the slots' rows
        (state leaves and the contiguous layout), and the slots' ``tok``,
        ``pos``, ``rem`` and ``plen``. Every write has a fixed shape: an
        admit batch's padding rows, and page rows past a slot's pages,
        repeat a live row's indices and values (``sel``, ``src``,
        ``dst``), so they rewrite its bytes. The captured graph on the
        card, run as it is on the CPU."""
        batch = dict(tokens=prog.tokens, length=prog.lengths,
                     **prog.stub)
        logits, pcache = self.model.prefill(self.params, batch)
        prog.firsts.copy_(torch.argmax(logits[:, -1], dim=-1))
        sel, slots = prog.sel, prog.slots
        for name, leaf in self._cache.items():
            bax, sax = self._axes[name]
            if sax != -1 and self._paged:
                KV.scatter_page_rows(leaf, pcache[name], prog.src, prog.dst,
                                     bax, sax)
                continue
            rows = pcache[name].movedim(bax, 0).index_select(0, sel)
            dst = leaf.movedim(bax, 0)
            if sax != -1:
                # the batch axis lies before the sequence axis, which the
                # move leaves where it was
                dst = dst.narrow(sax, 0, rows.shape[sax])
            dst[slots] = rows.to(leaf.dtype)
        i32 = torch.int32
        self._tok.index_copy_(0, slots,
                              prog.firsts.index_select(0, sel)[:, None])
        self._pos.index_copy_(0, slots,
                              prog.lengths.index_select(0, sel).to(i32))
        self._rem_dev.index_copy_(0, slots, prog.rem.to(i32))
        self._plen_dev.index_fill_(0, slots, 0)

    @contextmanager
    def _prefill_quiesced(self, prog: _PrefillProgram) -> Iterator[None]:
        """Inside the block the program's inputs send every write to slot
        0 and every page row to the trash page (page 0 of a plain pool);
        those targets (slot 0's rows of every unpaged leaf, that page of
        every paged one, and ``tok``, ``pos``, ``rem`` and ``plen``) are
        restored on exit. The warm-up runs of a capture run here, so they
        leave every pool and the slot state as they were, even between the
        steps of a live serve."""
        page = self.n_pages if self._pool_pages > self.n_pages else 0
        prog.load(np.zeros((prog.nb, prog.bucket), np.int64),
                  np.ones((prog.nb,), np.int64), np.zeros((prog.nb,)),
                  np.zeros((prog.nb,)), np.zeros((prog.nb,)),
                  np.arange(prog.nb * prog.n_rows),
                  np.full((prog.nb * prog.n_rows,), page))
        saved = [self._tok, self._pos, self._rem_dev, self._plen_dev]
        for name, leaf in self._cache.items():
            bax, sax = self._axes[name]
            saved.append(leaf.select(sax - 1, page)
                         if sax != -1 and self._paged
                         else leaf.select(bax, 0))
        with _restoring(saved):
            yield

    def _capture_prefill(self, prog: _PrefillProgram) -> None:
        """Capture the program's body as a CUDA graph, after one warm-up
        run on quiesced targets (``_prefill_quiesced``) on a side stream,
        in the engine's one prefill memory pool: dispatches run one after
        another and their outputs land in static buffers, so the graphs
        share it. Raises if the capture fails: no prefill runs op by op on
        the card."""
        dev = self.device
        if self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        side = side_stream(dev)
        with self._prefill_quiesced(prog):
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.no_grad():
                self._prefill_body(prog)
            torch.cuda.current_stream(dev).wait_stream(side)
        try:
            prog.graph, prog.launches = capture_graph(
                dev, lambda: self._prefill_body(prog), self._prefill_pool)
        except Exception as e:
            raise RuntimeError(
                f"capturing the prefill of {self.model.cfg.name} at "
                f"(nbatch, bucket) = ({prog.nb}, {prog.bucket}) failed: "
                f"{e}") from e

    def _run_prefill(self, prog: _PrefillProgram) -> None:
        """One dispatch of the program: a replay of its graph on the card,
        the body itself on the CPU."""
        if self.device.type != "cuda":
            with torch.no_grad():
                self._prefill_body(prog)
            return
        prog.graph.replay()
        build.credit(prog.launches, 1)
        self.stats["prefill_replays"] += 1

    # ------------------------------------------------------------------
    # speculative decoding: the propose, verify and resync programs
    def _capture_spec(self, prog: _SpecProgram) -> None:
        """Capture a speculative program as a CUDA graph on the card, after
        one warm-up run inside its quiesce context (which restores what
        the run wrote) on a side stream, in the engine's one speculative
        memory pool: the programs run one after another and their outputs
        land in static buffers. Nothing is captured on the CPU. Raises if
        the capture fails: no round runs op by op on the card."""
        if self.device.type != "cuda":
            return
        dev = self.device
        if self._spec_pool is None:
            self._spec_pool = torch.cuda.graph_pool_handle()
        side = side_stream(dev)
        with prog.quiesce():
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.no_grad():
                prog.body()
            torch.cuda.current_stream(dev).wait_stream(side)
        try:
            prog.graph, prog.launches = capture_graph(dev, prog.body,
                                                      self._spec_pool)
        except Exception as e:
            raise RuntimeError(f"capturing {prog.name} of "
                               f"{self.model.cfg.name} failed: {e}") from e

    def _run_spec(self, prog: _SpecProgram) -> None:
        """One run of a speculative program: a replay of its graph on the
        card (its launches credited), the body itself on the CPU."""
        if self.device.type != "cuda":
            with torch.no_grad():
                prog.body()
            return
        prog.graph.replay()
        build.credit(prog.launches, 1)

    def _verify_body(self) -> None:
        """The target's verify of one round over static buffers: the
        window ``[tok, drafts]`` teacher-forced at ``pos .. pos + k`` into
        the target cache, in place, and the target's argmax at every
        window position into ``preds``. The dense family verifies in one
        ``decode_window`` forward; the others in ``k + 1`` single-token
        decodes, one after another inside the one program."""
        toks = torch.cat([self._spec_tok, self._drafts], dim=1)
        pos = self._spec_pos
        if self.model.decode_window is not None:
            logits, _ = self.model.decode_window(self.params, self._dcache,
                                                 toks, pos)
            self._preds.copy_(torch.argmax(logits, dim=-1))
            return
        for i in range(self.spec_k + 1):
            logits, _ = self.model.decode(self.params, self._dcache,
                                          toks[:, i:i + 1], pos + i)
            self._preds[:, i].copy_(torch.argmax(logits[:, -1], dim=-1))

    def _get_verify(self) -> _SpecProgram:
        """The verify program, built (and on the card captured) once per
        engine and counted in ``verify_traces``; its warm-up run restores
        every cache leaf."""
        if self._verify is None:
            self._verify = _SpecProgram(
                "the speculative verify", self._verify_body,
                lambda: _restoring(list(self._cache.values())))
            self.stats["verify_traces"] += 1
            self._capture_spec(self._verify)
        return self._verify

    def _warm_spec(self) -> None:
        """Build (on the card, capture) every speculative program: the
        verify, the propose and a resync for every prompt bucket, so no
        capture happens mid-serve."""
        self._get_verify()
        self._spec.propose_program()
        for b in sorted({bucket_len(n, self.min_bucket, self.max_len)
                         for n in range(1, self.max_len)}):
            self._spec.resync_program(b)

    def _admit_group(self, bucket: int, rs: List[Request],
                     slots: List[int]) -> np.ndarray:
        """One prefill dispatch admitting same-bucket requests into slots.

        Admit batches are bucketed to {1, max_batch}, so a prompt bucket
        has at most two programs; padding rows (and page rows past a
        slot's pages) repeat row 0's writes. The first tokens come back in
        the dispatch's one host read."""
        m = len(rs)
        nb = 1 if m == 1 else self.max_batch
        prog = self._get_prefill(bucket, nb)
        tokens = np.zeros((nb, bucket), np.int64)
        lengths = np.ones((nb,), np.int64)
        for j, r in enumerate(rs):
            tokens[j, :len(r.prompt)] = r.prompt        # right-pad
            lengths[j] = len(r.prompt)
        sel = np.zeros((nb,), np.int64)
        sel[:m] = np.arange(m)
        rem = np.asarray([max(r.max_new_tokens, 1) - 1 for r in rs],
                         np.int64)
        src = dst = np.zeros((0,), np.int64)
        if self._paged:
            page_rows = np.full((nb, prog.n_rows), self.n_pages, np.int64)
            for j, (r, s) in enumerate(zip(rs, slots)):
                self._grow_slot(s, len(r.prompt))
                page_rows[j] = self._bt[s, :prog.n_rows]
            flat = page_rows.reshape(-1)
            kept = flat < self.n_pages
            # row 0's first page holds position 0 of a non-empty prompt
            assert kept[0], page_rows
            src = np.where(kept, np.arange(flat.size), 0)
            dst = np.where(kept, flat, flat[0])
        t0 = time.perf_counter()
        prog.load(tokens, lengths, sel, np.asarray(slots)[sel], rem[sel],
                  src, dst)
        self._run_prefill(prog)
        firsts_np = prog.firsts[:m].cpu().numpy()       # the one host sync
        self.timing["prefill_s"] += time.perf_counter() - t0
        self._rem[slots] = rem
        self._plen[slots] = 0
        for r, s in zip(rs, slots):
            self._slot_prefix[s] = np.asarray(r.prompt, np.int32)
            self._seat_credit[s] = 0
            self._set_digests(s, r.prompt)
        self.stats["prefill_dispatches"] += 1
        self.stats["admitted"] += m
        return firsts_np

    def _set_digests(self, slot: int, tokens: Optional[np.ndarray]) -> None:
        """Restart ``slot``'s prefix registration over the seated tokens
        (None: register nothing for this occupancy)."""
        if self._prefix is not None:
            self._seat_digests[slot] = ([] if tokens is None
                                        else self._prefix.chain(tokens))
            self._reg_upto[slot] = 0

    def _lookup_attach(self, slot: int,
                       tokens: np.ndarray) -> Optional[int]:
        """Prefix-cache lookup for a request about to be seated in
        ``slot`` (which already holds its reservation): attach the hit
        pages to the slot's block table (refcounted) and return the
        position the seat feeds from (the first uncached token), or None
        on a miss.

        When the hit covers every full page of the prompt, the seat still
        writes position ``plen - 1`` (its logits give the first token),
        inside the last shared page: that page is copied first unless the
        slot is its only holder, in which case it is written in place and
        unindexed until the write is harvested. So no write ever lands in
        a page of refcount above 1: the step writes only at each slot's
        ``pos`` through ``_bt_dev``, which takes the private copy before
        the next replay (``_sync_bt``)."""
        if self._prefix is None:
            return None
        hit = self._prefix.lookup(tokens)
        if not hit:
            return None
        ps = self.page_size
        plen = len(tokens)
        self._alloc.attach(slot, hit)
        self._bt[slot, :len(hit)] = hit
        self._bt_stale = True
        start = min(len(hit) * ps, plen - 1)
        if len(hit) * ps >= plen:
            if self._alloc.refcount(hit[-1]) > 1:
                old, new = self._alloc.cow(slot, len(hit) - 1)
                self._bt[slot, len(hit) - 1] = new
                self._copy_page(old, new)
                self.stats["cow_copies"] += 1
            else:
                self._prefix.unindex(hit[-1])
        self.stats["prefix_hits"] += 1
        self.stats["prefix_pages_reused"] += len(hit)
        self.stats["prefix_tokens_skipped"] += start
        return start

    def _copy_page(self, src: int, dst: int) -> None:
        """The device half of copy-on-write: physical page ``src`` copied
        into ``dst`` in every paged leaf, at a host boundary, outside the
        step graph (the copies are queued before the next replay)."""
        for name, leaf in self._cache.items():
            sax = self._axes[name][1]
            if sax != -1:
                KV.copy_pool_page(leaf, src, dst, sax, n_pages=self.n_pages)

    def _seat_prefix(self, slot: int, prefix: np.ndarray,
                     max_new: int, start: int = 0) -> None:
        """Seat a token prefix in ``slot`` for teacher-forced feeding: no
        prefill dispatch. The prefix goes to the slot's row of the device
        prompt buffer, and the next segments feed it one token a step from
        position ``start`` before the slot emits ``max_new`` greedy
        tokens. The primitive under chunked admission (prefix == prompt),
        the boundary seat of a staged request and preemption recovery
        (prefix == prompt + the tokens already generated). A prefix-cache
        hit passes ``start`` > 0: positions [0, start) are resident in the
        slot's attached pages, so the feed starts at ``row[start]``. The
        slot's per-slot state rows (the hybrid family's) restart from the
        empty state; the dense family has none."""
        n = len(prefix)
        row = np.zeros((self.max_len,), np.int32)
        row[:n] = prefix
        max_new = max(max_new, 1)
        self._pbuf[slot] = torch.from_numpy(row).to(self.device)
        for name, empty in self._reset_rows.items():
            self._cache[name].select(self._axes[name][0], slot).copy_(
                empty[0])
        self._plen_dev[slot] = n
        self._pos[slot] = start
        self._tok[slot, 0] = int(prefix[start])
        self._rem_dev[slot] = max_new
        self._plen[slot], self._slot_pos[slot], self._rem[slot] = \
            n, start, max_new
        self._slot_prefix[slot] = np.asarray(prefix, np.int32)
        self._seat_credit[slot] = 0
        self._set_digests(slot, prefix)

    def _admit_chunk(self, r: Request, slot: int) -> None:
        """Chunked admission: the prompt is seated for feeding through the
        decode segments, with no prefill dispatch."""
        self._seat_prefix(slot, np.asarray(r.prompt, np.int32),
                          r.max_new_tokens)
        self.stats["chunk_admits"] += 1
        self.stats["admitted"] += 1

    # ------------------------------------------------------------------
    # open-loop core: submit / step / drain_completions
    @property
    def busy(self) -> bool:
        """True while any request is pending admission, staged for
        in-segment admission, parked after a preemption, or mid-decode."""
        return bool(self._pending) or bool(self._staged) or \
            bool(self._preempted) or \
            any(r is not None for r in self._slot_req)

    def _validate(self, r: Request) -> None:
        if len(r.prompt) + r.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {r.rid}: prompt_len {len(r.prompt)} + max_new "
                f"{r.max_new_tokens} exceeds engine max_len {self.max_len}")
        if self._alloc is None:
            return
        need = self._alloc.pages_needed(self._n_positions(r))
        if need > self.n_pages:
            raise ValueError(
                f"request {r.rid}: needs {need} pages but the pool holds "
                f"{self.n_pages}; it could never be admitted")

    def submit(self, r: Request) -> None:
        """Enqueue a request (it joins at the next ``step()``). The latency
        clock starts at ``r.arrival`` (stamped now if unset)."""
        self._validate(r)
        if r.arrival == 0.0:
            r.arrival = time.perf_counter()
        self._pending.append(r)

    def _admit_pending(self) -> None:
        """Fill free slots, then top up the staging ring.

        Parked requests come first, never optimistically: a parked request
        waits until its whole worst case fits in free pages. One with a
        host swap payload is restored into fresh pages (``_swap_in``);
        the others re-hit the prefix cache where they can and replay the
        rest. Then staged requests that no segment pulled in take free
        slots (a boundary seat). Then, while nothing is parked, pending
        requests FIFO: under worst-case admission while the pool holds the
        head's worst case, under optimistic admission while free and
        cached pages hold its expected usage (a prefill its prompt pages,
        a chunked prompt its first ``decode_block`` stride, a prefix-cache
        hit the stride past its cached pages plus one for a copy). A hit
        is seated to feed from its first uncached token; prompts longer
        than ``chunk_threshold`` are seated for chunked prefill; the rest
        are prefilled grouped by prompt bucket. Last, the overflow is
        staged, each staged request reserving under a ticket with its
        first ``decode_block`` positions' pages covered: no host boundary
        can grow them inside a segment. Staged requests never look up the
        prefix cache (no page can be attached inside a segment), but their
        prompt pages register. The contiguous layout gates on free slots
        alone."""
        now = time.perf_counter()
        alloc = self._alloc
        strict = self.admission != "optimistic"
        while self._preempted and self._free:
            p = self._preempted[0]
            npos = self._n_positions(p.req)
            if alloc is not None:
                if not strict:
                    if alloc.pages_needed(npos) > alloc.n_avail:
                        break
                elif not alloc.can_reserve(npos):
                    break
            self._preempted.popleft()
            slot = self._free.pop()
            if p.kv is not None:
                alloc.reserve(slot, npos, strict=strict)
                self._swap_in(slot, p)
                continue
            start = None
            if alloc is not None:
                alloc.reserve(slot, npos, strict=strict)
                # the victim's registered prompt pages went cached when it
                # was preempted, so its replay usually re-hits them
                start = self._lookup_attach(slot, p.prefix)
                if not strict:
                    self._grow_slot(slot, min(npos, (start or 0)
                                              + self.decode_block))
            self._seat_prefix(slot, p.prefix,
                              p.req.max_new_tokens - len(p.done),
                              start=start or 0)
            self.stats["preempt_readmits"] += 1
            self._gen[slot] = list(p.done)
            # the seated prefix already holds the re-credited tokens
            self._seat_credit[slot] = len(p.done)
            self._slot_req[slot] = p.req
        while self._staged and self._free:
            r, ticket, bt_row = self._staged.popleft()
            self._ring_stale = True
            slot = self._free.pop()
            if alloc is not None:
                alloc.rekey(ticket, slot)
                self._bt[slot, :] = bt_row
                self._bt_stale = True
            r.admitted = now
            self._seat_prefix(slot, np.asarray(r.prompt, np.int32),
                              r.max_new_tokens)
            self.stats["admitted"] += 1
            self._gen[slot] = []
            self._slot_req[slot] = r
        prefills = []
        while self._pending and self._free and not self._preempted:
            r = self._pending[0]
            npos = self._n_positions(r)
            chunked = self.chunk_threshold is not None and \
                len(r.prompt) > self.chunk_threshold
            first = min(npos, self.decode_block) if chunked \
                else len(r.prompt)
            if alloc is not None:
                if not strict:
                    hit_est = len(self._prefix.lookup(r.prompt)) \
                        if self._prefix is not None else 0
                    if hit_est:
                        first = min(npos, hit_est * self.page_size
                                    + self.decode_block)
                        need = alloc.pages_needed(first) - hit_est + 1
                    else:
                        need = alloc.pages_needed(first)
                    if need > alloc.n_avail:
                        break
                elif not alloc.can_reserve(npos):
                    break                   # FIFO: nothing jumps the line
            self._pending.popleft()
            slot = self._free.pop()
            start = None
            if alloc is not None:
                alloc.reserve(slot, npos, strict=strict)
                start = self._lookup_attach(slot, r.prompt)
                if not strict:
                    # cover the expected pages now, so the obtainable-page
                    # count stays exact for the next head
                    if start is not None:
                        first = min(npos, start + self.decode_block)
                    self._grow_slot(slot, first)
            r.admitted = now
            if start is not None:
                # a cache hit skips the covered prompt: the seat feeds from
                # the first uncached token
                self._seat_prefix(slot, np.asarray(r.prompt, np.int32),
                                  r.max_new_tokens, start=start)
                self.stats["admitted"] += 1
                self._gen[slot] = []        # first token comes via emit
                self._slot_req[slot] = r
            elif chunked:
                self._admit_chunk(r, slot)
                self._gen[slot] = []        # first token comes via emit
                self._slot_req[slot] = r
            else:
                prefills.append((r, slot))
        groups: Dict[int, list] = {}
        for r, s in prefills:
            b = bucket_len(len(r.prompt), self.min_bucket, self.max_len)
            groups.setdefault(b, []).append((r, s))
        for b, pairs in sorted(groups.items()):
            for unit in ([pairs] if self._group_admit
                         else [[p] for p in pairs]):
                rs = [r for r, _ in unit]
                slots = [s for _, s in unit]
                firsts = self._admit_group(b, rs, slots)
                for r, s, f in zip(rs, slots, firsts):
                    self._gen[s] = [int(f)]
                    self._slot_req[s] = r
                    self._slot_pos[s] = len(r.prompt)
        while self.stage_slots and self._pending and \
                not self._preempted and len(self._staged) < self.stage_slots:
            r = self._pending[0]
            npos = self._n_positions(r)
            ticket = bt_row = None
            if alloc is not None:
                if strict:
                    if not alloc.can_reserve(npos):
                        break
                elif alloc.pages_needed(min(npos, self.decode_block)) > \
                        alloc.n_avail:
                    break
                ticket = ("stage", self._stage_seq)
                self._stage_seq += 1
                alloc.reserve(ticket, npos, strict=strict)
                pages = alloc.cover(ticket, min(npos, self.decode_block))
                bt_row = np.full((self.pages_per_slot,), self.n_pages,
                                 np.int32)
                bt_row[:len(pages)] = pages
            self._pending.popleft()
            self._staged.append((r, ticket, bt_row))
            self._ring_stale = True
            self.stats["staged"] += 1

    # ------------------------------------------------------------------
    # preemption: park / pick victim / relieve pressure
    def _preempt_slot(self, v: int) -> None:
        """Preempt ``v``'s occupant between segments: copy its pages to the
        host (``swap="host"``, where the gates allow), free them, park it
        with its prompt plus every token generated so far, and deactivate
        the slot on the device (``rem`` 0 in place)."""
        r = self._slot_req[v]
        done = self._gen[v][: r.max_new_tokens]
        prefix = np.concatenate([np.asarray(r.prompt, np.int32),
                                 np.asarray(done, np.int32)])
        r.preemptions += 1
        self.stats["preemptions"] += 1
        # the swap capture comes before the release: pages_of() is the
        # victim's block-table order, and a released page may be handed out
        # again and rewritten
        kv, swap_bytes = (self._swap_out(v)
                          if self.swap is not None else (None, 0))
        del self._gen[v]
        self._slot_req[v] = None
        self._free.append(v)
        if self._alloc is not None:
            # shared pages only lose this slot's reference; the victim's
            # registered prompt pages stay indexed (cached once idle)
            self._alloc.release(v)
            self._bt[v, :] = self.n_pages
            self._bt_stale = True
        self._preempted.append(_Parked(r, prefix, list(done), kv=kv,
                                       swap_bytes=swap_bytes))
        self._rem[v] = 0
        self._rem_dev[v] = 0

    def _swap_ok(self, v: int) -> bool:
        """Whether slot ``v``'s occupant passes the state gates of
        ``_swap_out``: past its seated-prefix feed (its fed tokens are
        ``pos``, and its prompt plus the tokens generated so far are them
        plus the pending token), still owing tokens, and holding pages.
        The layout and budget gates are ``_swap_out``'s own."""
        r = self._slot_req[v]
        if r is None or self._alloc is None:
            return False
        done_n = min(len(self._gen[v]), r.max_new_tokens)
        return (0 < done_n < r.max_new_tokens
                and int(self._slot_pos[v]) + 1 == len(r.prompt) + done_n
                and bool(self._alloc.pages_of(v)))

    def _swap_out(self, v: int):
        """Copy slot ``v``'s pages to host memory (``swap="host"``).

        Returns ``(payload, nbytes)``, or ``(None, 0)`` where a gate
        refuses, which counts ``swap_fallbacks`` and parks the victim for
        recompute: the paged layout with every leaf in the pool
        (``_all_paged``); the state gates of ``_swap_ok``; and the payload
        within ``swap_budget_bytes`` beside the payloads already parked.
        The payload is one plain host tensor a paged leaf, ``(pages held,
        page_size, ...)`` in block-table order: the bytes are copied, so
        shared pages are safe to take and every page can be reclaimed at
        once."""
        if not (self._paged and self._all_paged) or not self._swap_ok(v):
            self.stats["swap_fallbacks"] += 1
            return None, 0
        page_ids = self._alloc.pages_of(v)
        nbytes = 0
        for name, leaf in self._cache.items():
            pa = self._axes[name][1] - 1
            nbytes += (leaf.numel() // leaf.shape[pa]) * leaf.element_size() \
                * len(page_ids)
        if self.swap_budget_bytes is not None and \
                self._swap_live_bytes + nbytes > self.swap_budget_bytes:
            self.stats["swap_fallbacks"] += 1
            return None, 0
        payload = {name: KV.gather_pool_pages(leaf, page_ids,
                                              self._axes[name][1],
                                              n_pages=self.n_pages)
                   for name, leaf in self._cache.items()}
        self._swap_live_bytes += nbytes
        self.stats["swap_out"] += 1
        self.stats["swap_bytes"] += nbytes
        return payload, nbytes

    def _swap_in(self, slot: int, p: _Parked) -> None:
        """Re-admit a swapped-out victim into ``slot`` with no replay:
        fresh pages, the host payload scattered into them, and the decode
        state restored in place at this host boundary — ``tok`` the
        pending token, ``pos`` the fed tokens, ``rem`` the tokens still
        owed, ``plen`` 0 — with the host mirrors to match. The state is
        exactly what the victim was parked with, so the continuation is
        bit-identical. The caller has reserved the slot's worst case."""
        prefix = p.prefix
        n_held = next(iter(p.kv.values())).shape[0]
        pages = self._alloc.cover(slot, n_held * self.page_size)
        if len(pages) != n_held:
            raise RuntimeError(f"swap-in of request {p.req.rid}: "
                               f"{len(pages)} pages for {n_held} swapped")
        self._bt[slot, :n_held] = pages
        self._bt_stale = True
        for name, leaf in self._cache.items():
            KV.scatter_pool_pages(leaf, p.kv[name], pages,
                                  self._axes[name][1], n_pages=self.n_pages)
        pos = len(prefix) - 1
        rem = p.req.max_new_tokens - len(p.done)
        self._tok[slot, 0] = int(prefix[-1])
        self._pos[slot] = pos
        self._rem_dev[slot] = rem
        self._plen_dev[slot] = 0
        self._rem[slot], self._slot_pos[slot], self._plen[slot] = \
            rem, pos, 0
        self._gen[slot] = list(p.done)
        self._seat_credit[slot] = len(p.done)
        self._slot_prefix[slot] = np.asarray(prefix, np.int32)
        self._slot_req[slot] = p.req
        # the restored pages are private copies of unknown digests: no
        # prefix registration for this occupancy
        self._set_digests(slot, None)
        if self._spec is not None:
            self._spec.state[slot] = None
        self._swap_live_bytes -= p.swap_bytes
        self.stats["swap_in"] += 1
        self.stats["preempt_readmits"] += 1

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """A live slot to preempt, never ``exclude`` (the slot whose growth
        found the pool dry). ``slack`` picks the most slack — deadline
        minus elapsed minus the estimated rest (positions left times the
        step time's EWMA), infinite without an SLO — with ties toward
        fewer preemptions, then more positions left, then the higher slot;
        ``lru`` the most recently admitted."""
        cands = [s for s, r in enumerate(self._slot_req)
                 if r is not None and s != exclude]
        if not cands:
            return None
        if self.preempt_policy == "lru":
            return max(cands,
                       key=lambda s: (self._slot_req[s].admitted, s))
        now = time.perf_counter()

        def slack(s: int):
            r = self._slot_req[s]
            left = max(self._n_positions(r) - int(self._slot_pos[s]), 1)
            sl = float("inf") if r.slo is None \
                else (r.arrival + r.slo) - now - left * self._step_est
            return (sl, -r.preemptions, left, s)

        return max(cands, key=slack)

    def _relieve_pressure(self, protect: int) -> bool:
        """Free pages under pressure, cheapest first: un-stage the newest
        staged request (it returns to the head of pending), else preempt a
        victim. False when nothing is left to free."""
        if self._staged:
            r, ticket, _bt_row = self._staged.pop()
            self._ring_stale = True
            self._alloc.release(ticket)
            self._pending.appendleft(r)
            return True
        v = self._pick_victim(exclude=protect)
        if v is None:
            return False
        self._preempt_slot(v)
        return True

    def preempt(self, slot: int) -> None:
        """Preempt the request in ``slot`` (fault injection and tests; the
        engine preempts on its own under page pressure). It re-admits
        through a host swap-in where ``swap="host"`` and the swap gates
        (``_swap_out``) allow, and by replaying its prefix otherwise. Call
        between ``step()`` calls only."""
        if not self._chunk_ok:
            raise ValueError(
                f"family {self.model.cfg.family!r} cannot recover a "
                "preempted request (no teacher-forced replay path)")
        if not 0 <= slot < self.max_batch or self._slot_req[slot] is None:
            raise ValueError(f"slot {slot} is not live")
        self._preempt_slot(slot)

    def cancel(self, slot: int) -> None:
        """Cancel the request in ``slot`` (deadline enforcement): free its
        pages and the slot now and complete it with the tokens it has. Call
        between ``step()`` calls only."""
        if not 0 <= slot < self.max_batch or self._slot_req[slot] is None:
            raise ValueError(f"slot {slot} is not live")
        r = self._slot_req[slot]
        r.cancelled = True
        self._retire_slot(slot, r, time.perf_counter())
        self._free.append(slot)
        self._rem_dev[slot] = 0
        if self._spec is not None:
            self._spec.state[slot] = None

    def cancel_overdue(self, now: Optional[float] = None) -> int:
        """Cancel every request whose SLO deadline has passed: live slots
        through ``cancel``, pending and parked requests completed in place
        with what they have. Staged requests are swept once a slot holds
        them. Returns the number cancelled."""
        now = time.perf_counter() if now is None else now
        n = 0
        for s, r in enumerate(self._slot_req):
            if r is not None and r.slo is not None and \
                    now - r.arrival > r.slo:
                self.cancel(s)
                n += 1
        for q in (self._pending, self._preempted):
            keep: List[Any] = []
            while q:
                item = q.popleft()
                parked = isinstance(item, _Parked)
                r = item.req if parked else item
                if r.slo is None or now - r.arrival <= r.slo:
                    keep.append(item)
                    continue
                if parked:
                    # its pages were freed at preemption; only its host
                    # swap payload, if any, still charges the budget
                    self._swap_live_bytes -= item.swap_bytes
                r.tokens = np.asarray(
                    item.done[: r.max_new_tokens] if parked else (),
                    np.int32)
                r.cancelled = True
                r.latency = now - r.arrival
                self._completed.append(r)
                n += 1
            q.extend(keep)
        return n

    def _flush_stream(self, slot: int, r: Request, now: float) -> None:
        """Hand out the tokens past the request's streaming cursor (a no-op
        unless ``stream=True``)."""
        if not self.stream:
            return
        done = self._gen.get(slot)
        if done is None:
            return
        n = min(len(done), r.max_new_tokens)
        if n > r.streamed:
            if r.first_token < 0.0:
                r.first_token = now
            self._partial.append((r, [int(x) for x in done[r.streamed:n]],
                                  now))
            r.streamed = n

    def _retire_slot(self, slot: int, r: Request, now: float) -> None:
        """Finish ``slot``'s occupant: hand it its tokens, free its pages.
        The caller frees the slot or seats the next occupant."""
        self._flush_stream(slot, r, now)
        r.tokens = np.asarray(self._gen.pop(slot)[: r.max_new_tokens],
                              np.int32)
        r.latency = now - r.arrival
        self.stats["tokens_generated"] += len(r.tokens)
        self._slot_req[slot] = None
        self._rem[slot] = 0
        if self._alloc is not None:
            # the prefix cache keeps the pages it indexed, cached
            self._alloc.release(slot)
            self._bt[slot, :] = self.n_pages
            self._bt_stale = True
        self._completed.append(r)

    def _decode_segment(self, plan: SegmentPlan) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """Run the planned steps over every slot and return the emitted
        tokens (B, n_steps), -1 where a slot emitted nothing, and the
        completion log (n, 3). Both come back in one read at the end — the
        segment's one host sync — and the segment raises if the device's
        log, emissions or busy count differ from the plan."""
        self._sync_bt()
        self._sync_ring()
        self._out.fill_(-1)
        self._counters.zero_()
        self._step_i.zero_()
        self._run_steps(plan.n_steps)
        rb = self._rb.cpu().numpy()
        B, nb = self.max_batch, self.max_batch * self.decode_block
        C = self._max_comps + 1
        out = rb[:nb].reshape(B, self.decode_block)[:, :plan.n_steps]
        n_comp, busy, head = (int(x) for x in rb[nb + 3 * C:])
        log = np.stack([rb[nb + k * C:nb + k * C + min(n_comp, C - 1)]
                        for k in range(3)], 1)
        if not np.array_equal(log, plan.log) or busy != plan.busy or \
                head != int(plan.log[:, 2].sum()) or \
                not np.array_equal(out >= 0, plan.emits):
            raise RuntimeError(
                f"decode segment of {plan.n_steps} steps diverged from its "
                f"host plan: log {log.tolist()} ({n_comp} entries) against "
                f"{plan.log.tolist()}, busy {busy} against {plan.busy}, "
                f"ring head {head}")
        return out, log

    def _try_spec_step(self) -> Optional[int]:
        """One draft-then-verify round over the live slots; returns the
        window width ``spec_k + 1`` (counted as that many decode steps),
        or None when the step must run a decode segment instead.

        For a slot at ``(tok, pos)`` the draft proposes ``d_0 .. d_{k-1}``
        greedily from ``tok``; the target feeds ``[tok, d_0 .. d_{k-1}]``
        at ``pos .. pos + k`` and takes its argmax ``preds`` at each
        position. With ``m`` the first index where ``d_m != preds_m``
        (``k`` when all match), ``preds[0 .. m]`` are the tokens plain
        greedy decode emits, so the round emits ``m + 1`` and rewinds to
        ``(preds[m], pos + m + 1)``. KV rows past the rewind point are
        rewritten before a masked read can include them; the hybrid
        family re-seats the accepted prefix instead, since its state
        advanced through the rejected feeds.

        All or nothing: a live slot still feeding its seated prefix,
        within ``spec_k`` positions of its span's end (a clamped window
        write would overwrite valid KV), or whose pages cannot cover the
        window sends the step to a segment, so requests finish their last
        tokens through segments."""
        k = self.spec_k
        plan: List[Tuple[int, Request, int]] = []
        for s, r in enumerate(self._slot_req):
            if r is None:
                continue
            pos = int(self._slot_pos[s])
            if pos + 1 < len(self._slot_prefix[s]):
                return None         # still feeding its seated prefix
            if pos + k > self._n_positions(r) - 1:
                return None         # the window would write past its span
            plan.append((s, r, pos))
        if not plan:
            return None
        if self._alloc is not None:
            for s, _r, pos in plan:
                if not self._alloc.can_cover(s, pos + k + 1):
                    return None     # a segment handles the pressure
            for s, _r, pos in plan:
                self._grow_slot(s, pos + k + 1)
        runner = self._spec
        B = self.max_batch
        propose, verify = runner.propose_program(), self._get_verify()
        inp = np.zeros((2 * B,), np.int32)
        for s, r, pos in plan:
            full = self._fed_tokens(s)
            assert len(full) == pos + 1, (s, len(full), pos)
            if not runner.in_sync(s, r, pos):
                runner.resync(s, full, pos)
            inp[s], inp[B + s] = full[-1], pos
        self._sync_bt()
        t_seg = time.perf_counter()
        self._spec_in.copy_(torch.from_numpy(inp))
        self._run_spec(propose)
        self._run_spec(verify)
        out = self._spec_out.cpu().numpy()      # the one blocking sync
        dt = time.perf_counter() - t_seg
        self.timing["spec_s"] += dt
        drafts = out[:B * k].reshape(B, k)
        preds = out[B * k:].reshape(B, k + 1)
        # the host accept loop
        now = time.perf_counter()
        tpr = np.zeros((3, B), np.int32)        # tok, pos, rem written back
        tpr[1], tpr[2] = self._slot_pos, self._rem
        self.stats["decode_dispatches"] += 1
        self.stats["decode_steps"] += k + 1
        self.stats["spec_rounds"] += 1
        emitted = 0
        replay: List[int] = []
        seq_verify = self.model.decode_window is None
        for s, r, pos in plan:
            d, pr = drafts[s], preds[s]
            m = 0
            while m < k and d[m] == pr[m]:
                m += 1
            self.stats["spec_proposed"] += k
            self.stats["spec_accepted"] += m
            rem_s = int(self._rem[s])
            e = min(m + 1, rem_s)
            self._gen[s].extend(int(x) for x in pr[:e])
            emitted += e
            if e >= rem_s:
                tpr[2, s] = 0
                runner.state[s] = None
                self._retire_slot(s, r, now)
                self._free.append(s)
                continue
            tpr[:, s] = pr[m], pos + m + 1, rem_s - e
            self._rem[s], self._slot_pos[s] = rem_s - e, pos + m + 1
            # the draft's accepted rows hold the accepted tokens and its
            # stale tail is rewritten before use: the marker moves alone
            runner.state[s] = (r, pos + m + 1)
            if seq_verify and m < k:
                replay.append(s)
            self._flush_stream(s, r, now)
        self._tpr.copy_(torch.from_numpy(tpr.reshape(-1)))
        # the round did k + 1 positions of target work a slot; what
        # survived verification is progress, the rest counts as bubble
        self.stats["busy_slot_steps"] += emitted
        self.stats["bubble_slot_steps"] += (k + 1) * B - emitted
        per = dt / max(1.0, emitted / len(plan))
        self._step_est = per if self._step_est == 0.0 \
            else 0.8 * self._step_est + 0.2 * per
        # recurrent rollback: the sequential verify advanced the state
        # through the rejected feeds, so the accepted prefix is re-seated
        # through the teacher-forced replay (exact, as preemption
        # recovery is)
        for s in replay:
            r = self._slot_req[s]
            self._seat_prefix(s, self._fed_tokens(s),
                              max(r.max_new_tokens - len(self._gen[s]), 1))
            self._seat_credit[s] = len(self._gen[s])
            runner.state[s] = None
        self._register_prefix_pages()
        return k + 1

    def _fed_tokens(self, s: int) -> np.ndarray:
        """Slot ``s``'s token stream so far: its seated row and the tokens
        generated past it."""
        credit = int(self._seat_credit[s])
        return np.concatenate([self._slot_prefix[s],
                               np.asarray(self._gen[s][credit:], np.int32)])

    def step(self) -> int:
        """One engine step: admit pending requests into free slots (staging
        the overflow into the ring), grow every live slot's pages for the
        segment (relieving pressure under optimistic admission), run one
        decode segment and harvest it by its completion log. Returns the
        number of decode steps executed (0 when idle). A speculating
        engine first tries a draft-then-verify round
        (``_try_spec_step``); segments remain the path for prefix feeds,
        the last tokens of a request and page pressure."""
        if self.device.type == "cuda" and self._graph is None:
            self._capture()
        self._admit_pending()
        live = sum(r is not None for r in self._slot_req)
        if not live:
            return 0
        self.stats["peak_concurrency"] = max(
            self.stats["peak_concurrency"], live)
        if self._spec is not None:
            n = self._try_spec_step()
            if n is not None:
                return n
        # append pages ahead of the segment: a slot's pos advances by at
        # most decode_block before the next host boundary. Worst-case
        # reservations pre-fund every cover; under optimistic admission a
        # dry pool un-stages and then preempts until the cover fits
        for s, r in enumerate(self._slot_req):
            if r is None or self._alloc is None:
                continue
            cover = min(int(self._slot_pos[s]) + self.decode_block,
                        self._n_positions(r))
            if not self._alloc.can_cover(s, cover):
                self.stats["pressure_stalls"] += 1
                while not self._alloc.can_cover(s, cover):
                    if not self._relieve_pressure(protect=s):
                        break
            self._grow_slot(s, cover)
        plan = plan_segment(
            self._rem, self._slot_pos, self._plen,
            [(len(r.prompt), max(r.max_new_tokens, 1))
             for r, _t, _b in self._staged], self.decode_block)
        self.stats["decode_dispatches"] += 1
        out, log = np.zeros((self.max_batch, 0), np.int32), plan.log
        if plan.n_steps:
            t0 = time.perf_counter()
            out, log = self._decode_segment(plan)
            dt = time.perf_counter() - t0
            self.timing["decode_s"] += dt
            per = dt / plan.n_steps
            self._step_est = per if self._step_est == 0.0 \
                else 0.8 * self._step_est + 0.2 * per
        self.stats["decode_steps"] += plan.n_steps
        self.stats["busy_slot_steps"] += plan.busy
        self.stats["bubble_slot_steps"] += \
            plan.n_steps * self.max_batch - plan.busy
        now = time.perf_counter()
        # the completion log in segment order: each record closes the
        # slot's occupant over its slice of out; an admitted record then
        # seats the next staged request (the ring is FIFO, as _staged)
        consumed = np.zeros((self.max_batch,), np.int64)
        for s, t, adm in log.tolist():
            row = out[s, consumed[s]:t + 1]
            self._gen[s].extend(int(x) for x in row[row >= 0])
            consumed[s] = t + 1
            self._retire_slot(s, self._slot_req[s], now)
            if adm:
                nr, ticket, bt_row = self._staged.popleft()
                self._ring_stale = True
                if self._alloc is not None:
                    self._alloc.rekey(ticket, s)
                    self._bt[s, :] = bt_row
                    self._bt_stale = True
                nr.admitted = now
                self._slot_req[s] = nr
                self._gen[s] = []
                self._slot_prefix[s] = np.asarray(nr.prompt, np.int32)
                self._seat_credit[s] = 0
                # a staged seat never looked the cache up (no page can be
                # attached inside a segment), but its prompt pages register
                self._set_digests(s, nr.prompt)
                self.stats["admitted"] += 1
                self.stats["inseg_admissions"] += 1
            else:
                self._free.append(s)
        self._rem, self._slot_pos, self._plen = plan.rem, plan.pos, plan.plen
        for s, r in enumerate(self._slot_req):
            if r is None:
                continue
            row = out[s, consumed[s]:]
            self._gen[s].extend(int(x) for x in row[row >= 0])
            self._flush_stream(s, r, now)
        # a prefilled request with max_new == 1 is complete at admission
        for s, r in enumerate(self._slot_req):
            if r is not None and self._rem[s] == 0:
                self._retire_slot(s, r, now)
                self._free.append(s)
        self._register_prefix_pages()
        return plan.n_steps

    def _register_prefix_pages(self) -> None:
        """Index every prompt page the last segment fully wrote (the slot's
        position passed its end). Host bookkeeping only: the pages' bytes
        come from that segment's device work, which any later use of them
        is queued behind."""
        if self._prefix is None:
            return
        for s, r in enumerate(self._slot_req):
            if r is None or not self._seat_digests[s]:
                continue
            done = int(self._reg_upto[s])
            n_ready = min(int(self._slot_pos[s]) // self.page_size,
                          len(self._seat_digests[s]))
            if n_ready > done:
                self._prefix.register(
                    self._seat_digests[s][done:n_ready],
                    [int(p) for p in self._bt[s, done:n_ready]])
                self._reg_upto[s] = n_ready
        self.stats["evictions"] = self._alloc.evictions

    def drain_completions(self) -> List[Request]:
        """Return (and clear) the requests completed since the last drain."""
        out, self._completed = self._completed, []
        return out

    def drain_partial_outputs(self) -> List[Tuple[Request, List[int], float]]:
        """Return (and clear) the ``(request, new_tokens, t_wall)`` chunks
        harvested since the last drain (``stream=True`` engines). One
        request's chunks come in emission order and concatenate to its
        ``tokens``."""
        out, self._partial = self._partial, []
        return out

    @property
    def occupancy(self) -> Dict[str, float]:
        """Slot-busy fraction over all decode segments so far, in-segment
        admissions per segment, the idle slot-steps, the prefix cache's
        counts (zeros with it off) and the share of draft tokens accepted
        (0 without speculation)."""
        busy = self.stats["busy_slot_steps"]
        bubble = self.stats["bubble_slot_steps"]
        segs = self.stats["decode_dispatches"]
        total = busy + bubble
        if self._alloc is not None:
            self.stats["evictions"] = self._alloc.evictions
        occ = {"slot_busy_frac": busy / total if total else 0.0,
               "admissions_per_segment":
                   self.stats["inseg_admissions"] / segs if segs else 0.0,
               "bubble_slot_steps": float(bubble),
               "segments": float(segs)}
        for key in ("prefix_hits", "prefix_pages_reused",
                    "prefix_tokens_skipped", "cow_copies", "evictions"):
            occ[key] = float(self.stats[key])
        prop = self.stats["spec_proposed"]
        occ["spec_accept_rate"] = (self.stats["spec_accepted"] / prop
                                   if prop else 0.0)
        return occ

    def serve(self, reqs: Sequence[Request]) -> List[Request]:
        """Serve requests to completion: submit all, step until done.

        Completions of requests submitted by other callers stay queued for
        their ``drain_completions()``."""
        for r in reqs:
            self._validate(r)
        for r in reqs:
            self.submit(r)
        while self.busy and any(r.tokens is None for r in reqs):
            self.step()
        mine = {id(r) for r in reqs}
        self._completed = [r for r in self._completed if id(r) not in mine]
        return list(reqs)
