"""Continuous-batching serving engine over a paged KV cache
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
{1, max_batch}; padding rows carry slot ``max_batch`` and are dropped),
their paged leaves are scattered into the pools through the block table
and their state rows are written by slot. The audio and vlm families get
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
per-slot state rows, so, as in the JAX engine, they clamp
``chunk_threshold`` to None, ``stage_slots`` to 0 and ``admission`` to
worst-case, and cannot be preempted.

**Kernel pool layout.** With ``attention_impl="cuda"`` every pool carries
one extra *trash* page at index ``n_pages``, the block table's sentinel: the
fused decode kernel has no write suppression, so inactive slots write
there, and prefill rows past a slot's pages land there too; the paged
decode kernel's clamped sentinel reads land there as well. The plain path
keeps the exact-size pool and drops those writes instead. Either way no
write touches a live page.

**In place.** Pools and the loop state are updated in place (the JAX
engine is functional). The warm-up steps a capture needs run with every
slot inactive, every block-table row at the sentinel and the ring empty,
so their writes are dropped, and the loop state is restored afterwards.

Knobs of the JAX engine that this slice lacks — the contiguous layout
(``page_size=None``), ``prefix_cache``, ``swap`` and ``speculate`` — raise
``NotImplementedError`` rather than being ignored.
"""
from __future__ import annotations

import dataclasses
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
    ``can_cover``. No page is held by two holders, free + held pages ==
    ``n_pages`` at all times, and a full drain returns every page.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool: {n_pages} pages x {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages))[::-1]
        self._pages: Dict[Any, List[int]] = {}
        self._reserved: Dict[Any, int] = {}

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
    def n_avail(self) -> int:
        """Pages a cover can obtain (the free list: no cached pool yet)."""
        return len(self._free)

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
        """Enough free pages for ``cover(holder, n_positions)``? Always
        true under worst-case admission; the pressure probe of optimistic
        admission."""
        held = len(self._pages[holder])
        target = min(self.pages_needed(n_positions), self._reserved[holder])
        return target - held <= self.n_avail

    def cover(self, holder: Any, n_positions: int) -> List[int]:
        """Grow ``holder`` to cover positions [0, n); returns the new pages."""
        held = self._pages[holder]
        target = min(self.pages_needed(n_positions), self._reserved[holder])
        grown = []
        while len(held) < target:
            page = self._free.pop()
            grown.append(page)
            held.append(page)
        return grown

    def release(self, holder: Any) -> List[int]:
        """Return all of ``holder``'s pages to the free list."""
        pages = self._pages.pop(holder)
        del self._reserved[holder]
        self._free.extend(pages)
        return pages

    def rekey(self, old: Any, new: Any) -> None:
        """Move a reservation and its pages to a new holder key: a staged
        request's ticket becomes the slot it was pulled into."""
        if new in self._reserved:
            raise ValueError(f"holder {new!r} already live")
        self._reserved[new] = self._reserved.pop(old)
        self._pages[new] = self._pages.pop(old)


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


class ServingEngine:
    """Continuous-batching engine over one model + params (greedy decode)."""

    def __init__(self, model: Model, params: Any, max_batch: int = 8,
                 max_len: int = 128, decode_block: int = 16,
                 min_bucket: int = 8, page_size: Optional[int] = 16,
                 n_pages: Optional[int] = None,
                 chunk_threshold: Optional[int] = None,
                 stage_slots: int = 0, admission: str = "worstcase",
                 preempt_policy: str = "slack",
                 prefix_cache: bool = False, swap: Optional[str] = None,
                 speculate: Optional[Any] = None, stream: bool = False):
        unported = {
            "page_size=None (the contiguous KV layout)": page_size is None,
            "prefix_cache": bool(prefix_cache),
            "swap": swap is not None,
            "speculate": speculate is not None,
        }
        missing = [k for k, on in unported.items() if on]
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(missing))
        if admission not in ("worstcase", "optimistic"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if preempt_policy not in ("slack", "lru"):
            raise ValueError(f"unknown preempt policy {preempt_policy!r}")
        if max_len % page_size != 0:
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
        # chunked prefill, the staging ring and preemption recovery restart
        # a slot from an empty decode state; the audio and vlm families
        # need encoder KV from prefill and admit whole prompts, as in the
        # JAX engine (whose moe family, not ported, is clamped too)
        self._chunk_ok = cfg.family == "dense"
        self.chunk_threshold = chunk_threshold if self._chunk_ok else None
        self.stage_slots = int(stage_slots) if self._chunk_ok else 0
        self.admission = admission if self._chunk_ok else "worstcase"
        self.preempt_policy = preempt_policy
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.n_pages = (max_batch * self.pages_per_slot if n_pages is None
                        else n_pages)
        self._alloc = PageAllocator(self.n_pages, page_size)
        # the fused kernel writes inactive slots' rows into a trash page at
        # the sentinel index; the plain path drops those writes instead
        self._pool_pages = self.n_pages + (
            1 if cfg.attention_impl == "cuda" else 0)
        shapes = model.cache_shapes(max_batch, max_len, enc_len=max_len)
        self._axes = KV.leaf_axes(model.cache_shapes, max_len)
        self._cache = {}
        for name, (dims, dtype) in shapes.items():
            bax, sax = self._axes[name]
            if sax != -1:
                dims = KV.pool_shape(dims, bax, sax, self._pool_pages,
                                     page_size)
            self._cache[name] = torch.zeros(dims, dtype=dtype,
                                            device=self.device)
        # the block table: a host copy that admission and growth edit, and
        # its static device buffer, refreshed in place before a segment
        self._bt = KV.sentinel_block_table(max_batch, self.pages_per_slot,
                                           self.n_pages)
        self._bt_dev = torch.from_numpy(self._bt).to(self.device)
        self._bt_stale = False
        # the decode loop state (the reference's carry), static buffers
        # that a captured step reads and writes at fixed addresses
        i32 = dict(dtype=torch.int32, device=self.device)
        self._tok = torch.zeros((max_batch, 1), **i32)
        self._pos = torch.zeros((max_batch,), **i32)
        self._rem_dev = torch.zeros((max_batch,), **i32)
        self._plen_dev = torch.zeros((max_batch,), **i32)
        self._pbuf = torch.zeros((max_batch, max_len), **i32)
        self._step_i = torch.zeros((1,), dtype=torch.long,
                                   device=self.device)
        self._slot_ids = torch.arange(max_batch, **i32)
        # the staging ring, one buffer written by one host copy: prompt
        # rows (R, max_len), prompt lengths and max_new (R,), block-table
        # rows (R, pages_per_slot) and the count of valid entries
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
        self._dcache = dict(self._cache, bt=self._bt_dev)
        self._graph: Optional[Any] = None
        self._graph_launches: Dict[str, int] = {}
        # host mirrors of rem, pos and plen: they plan each segment and
        # split its emitted tokens between the slots
        self._rem = np.zeros((max_batch,), np.int64)
        self._slot_pos = np.zeros((max_batch,), np.int64)
        self._plen = np.zeros((max_batch,), np.int64)
        self.stats: Dict[str, int] = {
            "decode_traces": 0, "prefill_dispatches": 0,
            "decode_dispatches": 0, "decode_steps": 0,
            "tokens_generated": 0, "admitted": 0, "chunk_admits": 0,
            "peak_concurrency": 0, "staged": 0, "inseg_admissions": 0,
            "busy_slot_steps": 0, "bubble_slot_steps": 0,
            "preemptions": 0, "preempt_readmits": 0, "pressure_stalls": 0,
            "graph_replays": 0,
        }
        # host wall seconds spent in prefill dispatches and decode
        # segments, each ending in its host sync, and in the graph
        # replay calls of the segments (their enqueue alone)
        self.timing: Dict[str, float] = {"prefill_s": 0.0, "decode_s": 0.0,
                                         "replay_s": 0.0}
        self._pending: deque = deque()
        self._slot_req: List[Optional[Request]] = [None] * max_batch
        self._gen: Dict[int, List[int]] = {}
        self._free: List[int] = list(range(max_batch))[::-1]
        self._completed: List[Request] = []
        # each slot's seated token row (prompt, or replay prefix) and how
        # many of its _gen entries that row already holds (re-credits)
        self._slot_prefix: List[Optional[np.ndarray]] = [None] * max_batch
        self._seat_credit = np.zeros((max_batch,), np.int64)
        # the staged FIFO (request, allocator ticket, block-table row),
        # mirrored into the device ring
        self._staged: deque = deque()
        self._stage_seq = 0
        # preempted requests parked on the host (``_Parked``), FIFO
        self._preempted: deque = deque()
        # EWMA of a decode step's wall time: the slack policy's estimate
        # of a request's remaining service time
        self._step_est = 0.0
        self._partial: List[Tuple[Request, List[int], float]] = []

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
        if self._bt_stale:
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
        # the refilled slot's block-table row, read by the next step
        self._bt_dev.copy_(torch.where(
            adm[:, None], self._ring_bt.index_select(0, src), self._bt_dev))
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
        counter and the block table are restored on exit."""
        saved = [(t, t.clone()) for t in (
            self._tok, self._pos, self._rem_dev, self._plen_dev,
            self._pbuf, self._ring, self._rb, self._step_i, self._bt_dev)]
        self._rem_dev.zero_()
        self._bt_dev.fill_(self.n_pages)
        self._n_stage.zero_()
        try:
            yield
        finally:
            for t, v in saved:
                t.copy_(v)

    def _warm_steps(self, n: int = WARM_STEPS) -> None:
        """Run the step body ``n`` times on quiesced state: the warm-up
        that a capture needs, which leaves pools and slot state as they
        were."""
        with self._quiesced(), torch.no_grad():
            for _ in range(n):
                self._step_i.zero_()
                self._step_body()

    def _capture(self) -> None:
        """Capture one step of the body as a CUDA graph, once per engine.

        Raises if the capture fails: no segment runs the eager loop on the
        card."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._warm_steps()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with build.capturing() as launches, torch.no_grad(), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step_body()
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
        """Build the kernels (on CUDA), run one prefill on scratch and, on
        CUDA, capture the decode step.

        The JAX engine compiles its programs here; the port builds its
        kernel libraries, warms the device allocator and libraries with a
        prefill whose outputs are discarded, and captures the step graph.
        Nothing touches the live pools or slot state. Prompts that chunked
        admission takes never prefill and are left out.
        """
        cfg = self.model.cfg
        if cfg.attention_impl == "cuda" or cfg.quantize == "int8_cuda":
            build.build_all()
        lens = [n for n in prompt_lens if self.chunk_threshold is None
                or n <= self.chunk_threshold]
        b = bucket_len(max([1, *lens]), self.min_bucket, self.max_len)
        with torch.no_grad():
            self.model.prefill(self.params, self._prefill_batch(
                np.zeros((1, b), np.int32)))
        if self.device.type == "cuda":
            if self._graph is None:
                self._capture()
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

    def _prefill_batch(self, tokens: np.ndarray,
                       lengths: Optional[np.ndarray] = None):
        """A prefill batch on the device, with the family's stub encoder
        input: all zeros, as the JAX engine feeds it."""
        cfg, dev = self.model.cfg, self.device
        nb, bucket = tokens.shape
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if lengths is not None:
            batch["length"] = torch.from_numpy(lengths).to(dev)
        dtype = DTYPES[cfg.dtype]
        if cfg.family == "audio":
            batch["frames"] = torch.zeros((nb, bucket, cfg.d_model),
                                          dtype=dtype, device=dev)
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (nb, cfg.n_image_tokens, cfg.d_model), dtype=dtype,
                device=dev)
        return batch

    def _insert_prefill(self, pcache, page_rows: np.ndarray,
                        slot_t: torch.Tensor) -> None:
        """Write an admit batch's prefill cache into the engine's leaves.

        Paged leaves go page by page through ``page_rows``. Rows whose page
        is the sentinel land in the trash page when the pool has one and are
        dropped otherwise (JAX's ``mode="drop"``): they are the padding rows
        of the admit batch and bucket padding past a slot's pages, and never
        reach a live page. State leaves take their first ``len(slot_t)`` rows
        by slot; the padding rows after them are dropped.
        """
        for name, leaf in self._cache.items():
            bax, sax = self._axes[name]
            if sax == -1:
                rows = pcache[name].movedim(bax, 0)[:len(slot_t)]
                leaf.movedim(bax, 0)[slot_t] = rows.to(leaf.dtype)
            else:
                KV.scatter_pages(leaf, pcache[name], page_rows, bax, sax)

    def _admit_group(self, bucket: int, rs: List[Request],
                     slots: List[int]) -> np.ndarray:
        """One prefill dispatch admitting same-bucket requests into slots."""
        m = len(rs)
        nb = 1 if m == 1 else self.max_batch
        tokens = np.zeros((nb, bucket), np.int32)
        lengths = np.ones((nb,), np.int32)
        for j, r in enumerate(rs):
            tokens[j, :len(r.prompt)] = r.prompt        # right-pad
            lengths[j] = len(r.prompt)
        n_rows = self._page_rows_for(bucket)
        page_rows = np.full((nb, n_rows), self.n_pages, np.int32)
        for j, (r, s) in enumerate(zip(rs, slots)):
            self._grow_slot(s, len(r.prompt))
            page_rows[j] = self._bt[s, :n_rows]
        rem = np.asarray([max(r.max_new_tokens, 1) - 1 for r in rs],
                         np.int32)
        t0 = time.perf_counter()
        dev = self.device
        batch = self._prefill_batch(tokens, lengths)
        slot_t = torch.as_tensor(slots, dtype=torch.long, device=dev)
        with torch.no_grad():
            logits, pcache = self.model.prefill(self.params, batch)
            firsts = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            self._insert_prefill(pcache, page_rows, slot_t)
        self._tok[slot_t] = firsts[:m, None]
        self._pos[slot_t] = batch["length"][:m]
        self._rem_dev[slot_t] = torch.from_numpy(rem).to(dev)
        self._plen_dev[slot_t] = 0
        firsts_np = firsts[:m].cpu().numpy()            # the one host sync
        self.timing["prefill_s"] += time.perf_counter() - t0
        self._rem[slots] = rem
        self._plen[slots] = 0
        for r, s in zip(rs, slots):
            self._slot_prefix[s] = np.asarray(r.prompt, np.int32)
            self._seat_credit[s] = 0
        self.stats["prefill_dispatches"] += 1
        self.stats["admitted"] += m
        return firsts_np

    def _seat_prefix(self, slot: int, prefix: np.ndarray,
                     max_new: int) -> None:
        """Seat a token prefix in ``slot`` for teacher-forced feeding: no
        prefill dispatch. The prefix goes to the slot's row of the device
        prompt buffer, and the next segments feed it one token a step
        before the slot emits ``max_new`` greedy tokens. The primitive
        under chunked admission (prefix == prompt), the boundary seat of a
        staged request and preemption recovery (prefix == prompt + the
        tokens already generated). The dense family has no O(1) state to
        reset."""
        n = len(prefix)
        row = np.zeros((self.max_len,), np.int32)
        row[:n] = prefix
        max_new = max(max_new, 1)
        self._pbuf[slot] = torch.from_numpy(row).to(self.device)
        self._plen_dev[slot] = n
        self._pos[slot] = 0
        self._tok[slot, 0] = int(prefix[0])
        self._rem_dev[slot] = max_new
        self._plen[slot], self._slot_pos[slot], self._rem[slot] = \
            n, 0, max_new
        self._slot_prefix[slot] = np.asarray(prefix, np.int32)
        self._seat_credit[slot] = 0

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
        waits until its whole worst case fits in free pages. Then staged
        requests that no segment pulled in take free slots (a boundary
        seat). Then, while nothing is parked, pending requests FIFO: under
        worst-case admission while the pool holds the head's worst case,
        under optimistic admission while free pages hold its expected
        usage (a prefill its prompt pages, a chunked prompt its first
        ``decode_block`` stride). Prompts longer than ``chunk_threshold``
        are seated for chunked prefill, the rest prefilled grouped by
        prompt bucket. Last, the overflow is staged, each staged request
        reserving under a ticket with its first ``decode_block``
        positions' pages covered: no host boundary can grow them inside a
        segment."""
        now = time.perf_counter()
        strict = self.admission != "optimistic"
        while self._preempted and self._free:
            p = self._preempted[0]
            npos = self._n_positions(p.req)
            if strict:
                if not self._alloc.can_reserve(npos):
                    break
            elif self._alloc.pages_needed(npos) > self._alloc.n_avail:
                break
            self._preempted.popleft()
            slot = self._free.pop()
            self._alloc.reserve(slot, npos, strict=strict)
            if not strict:
                self._grow_slot(slot, min(npos, self.decode_block))
            self._seat_prefix(slot, p.prefix,
                              p.req.max_new_tokens - len(p.done))
            self.stats["preempt_readmits"] += 1
            self._gen[slot] = list(p.done)
            # the seated prefix already holds the re-credited tokens
            self._seat_credit[slot] = len(p.done)
            self._slot_req[slot] = p.req
        while self._staged and self._free:
            r, ticket, bt_row = self._staged.popleft()
            self._ring_stale = True
            slot = self._free.pop()
            self._alloc.rekey(ticket, slot)
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
            if strict:
                if not self._alloc.can_reserve(npos):
                    break                   # FIFO: nothing jumps the line
            elif self._alloc.pages_needed(first) > self._alloc.n_avail:
                break
            self._pending.popleft()
            slot = self._free.pop()
            self._alloc.reserve(slot, npos, strict=strict)
            if not strict:
                # cover the expected pages now, so the free-page count
                # stays exact for the next head
                self._grow_slot(slot, first)
            r.admitted = now
            if chunked:
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
            rs = [r for r, _ in pairs]
            slots = [s for _, s in pairs]
            firsts = self._admit_group(b, rs, slots)
            for r, s, f in zip(rs, slots, firsts):
                self._gen[s] = [int(f)]
                self._slot_req[s] = r
                self._slot_pos[s] = len(r.prompt)
        while self.stage_slots and self._pending and \
                not self._preempted and len(self._staged) < self.stage_slots:
            r = self._pending[0]
            npos = self._n_positions(r)
            if strict:
                if not self._alloc.can_reserve(npos):
                    break
            elif self._alloc.pages_needed(min(npos, self.decode_block)) > \
                    self._alloc.n_avail:
                break
            self._pending.popleft()
            ticket = ("stage", self._stage_seq)
            self._stage_seq += 1
            self._alloc.reserve(ticket, npos, strict=strict)
            pages = self._alloc.cover(ticket, min(npos, self.decode_block))
            bt_row = np.full((self.pages_per_slot,), self.n_pages, np.int32)
            bt_row[:len(pages)] = pages
            self._staged.append((r, ticket, bt_row))
            self._ring_stale = True
            self.stats["staged"] += 1

    # ------------------------------------------------------------------
    # preemption: park / pick victim / relieve pressure
    def _preempt_slot(self, v: int) -> None:
        """Preempt ``v``'s occupant between segments: free its pages, park
        it with its prompt plus every token generated so far, and
        deactivate the slot on the device (``rem`` 0 in place)."""
        r = self._slot_req[v]
        done = self._gen.pop(v)[: r.max_new_tokens]
        prefix = np.concatenate([np.asarray(r.prompt, np.int32),
                                 np.asarray(done, np.int32)])
        r.preemptions += 1
        self.stats["preemptions"] += 1
        self._slot_req[v] = None
        self._free.append(v)
        self._alloc.release(v)
        self._bt[v, :] = self.n_pages
        self._bt_stale = True
        self._preempted.append(_Parked(r, prefix, list(done)))
        self._rem[v] = 0
        self._rem_dev[v] = 0

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
        engine preempts on its own under page pressure). It re-admits by
        replaying its prefix. Call between ``step()`` calls only."""
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

    def step(self) -> int:
        """One engine step: admit pending requests into free slots (staging
        the overflow into the ring), grow every live slot's pages for the
        segment (relieving pressure under optimistic admission), run one
        decode segment and harvest it by its completion log. Returns the
        number of decode steps executed (0 when idle)."""
        if self.device.type == "cuda" and self._graph is None:
            self._capture()
        self._admit_pending()
        live = sum(r is not None for r in self._slot_req)
        if not live:
            return 0
        self.stats["peak_concurrency"] = max(
            self.stats["peak_concurrency"], live)
        # append pages ahead of the segment: a slot's pos advances by at
        # most decode_block before the next host boundary. Worst-case
        # reservations pre-fund every cover; under optimistic admission a
        # dry pool un-stages and then preempts until the cover fits
        for s, r in enumerate(self._slot_req):
            if r is None:
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
                self._alloc.rekey(ticket, s)
                self._bt[s, :] = bt_row
                self._bt_stale = True
                nr.admitted = now
                self._slot_req[s] = nr
                self._gen[s] = []
                self._slot_prefix[s] = np.asarray(nr.prompt, np.int32)
                self._seat_credit[s] = 0
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
        return plan.n_steps

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
        admissions per segment and the idle slot-steps."""
        busy = self.stats["busy_slot_steps"]
        bubble = self.stats["bubble_slot_steps"]
        segs = self.stats["decode_dispatches"]
        total = busy + bubble
        return {"slot_busy_frac": busy / total if total else 0.0,
                "admissions_per_segment":
                    self.stats["inseg_admissions"] / segs if segs else 0.0,
                "bubble_slot_steps": float(bubble),
                "segments": float(segs)}

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
