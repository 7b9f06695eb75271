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
prompt buffer ``pbuf`` (B, max_len), the emitted tokens ``out`` (B,
decode_block) and a step counter, beside the block table and every cache
leaf. Host code writes them only in place. One function, ``_step_body``,
is the reference's loop body without the staging ring and completion log:
decode one token for every slot, take the argmax, feed the next prompt
token instead while a chunked prompt remains (``feeding``), write the
emitted token (-1 where none) into ``out`` at the step counter, and
advance ``tok``, ``pos`` and ``rem`` where the slot is active
(``rem > 0``). On the CPU a segment calls it ``n_steps`` times. On the card
it is captured once per engine as a CUDA graph (``warmup()``, or the first
``step()`` while no slot is live) and a segment replays that graph
``n_steps`` times; a capture that fails raises, and nothing falls back to
the eager loop. ``n_steps`` is the reference's early exit,
``min(decode_block, max over live slots of feed steps left + rem)``, from
the host's mirrors of ``pos``, ``rem`` and ``plen``; the emitted tokens
are read back once, at the segment's end. ``decode_steps``,
``decode_dispatches``, ``busy_slot_steps`` and ``chunk_admits`` count
exactly what the JAX engine counts on the same stream; ``decode_traces``
counts captured graphs (1 per engine on the card, 0 on the CPU) and
``graph_replays`` the steps run as replays. The launch counts a capture
records are credited once per replay (``kernels.build.credit``).

**Chunked prefill** (``chunk_threshold``). A prompt longer than the
threshold takes a free slot FIFO under the same worst-case reservation but
gets no prefill dispatch: it is seated in the slot's row of ``pbuf``
(``plen``, ``pos`` 0, ``tok`` its first token, ``rem`` max_new) and fed
through the decode segments one token a step, writing its KV, until the
slot emits. As in the JAX engine, families whose prefill computes encoder
KV (audio, vlm) admit whole prompts: the knob is clamped to None for them.

**Kernel pool layout.** With ``attention_impl="cuda"`` every pool carries
one extra *trash* page at index ``n_pages``, the block table's sentinel: the
fused decode kernel has no write suppression, so inactive slots write
there, and prefill rows past a slot's pages land there too; the paged
decode kernel's clamped sentinel reads land there as well. The plain path
keeps the exact-size pool and drops those writes instead. Either way no
write touches a live page.

**In place.** Pools and the loop state are updated in place (the JAX
engine is functional). The warm-up steps a capture needs run with every
slot inactive and every block-table row at the sentinel, so their writes
are dropped, and the loop state is restored afterwards.

Knobs of the JAX engine that this slice lacks — the contiguous layout
(``page_size=None``), ``stage_slots``, ``admission="optimistic"``,
``prefix_cache``, ``swap``, ``speculate`` and ``stream`` — raise
``NotImplementedError`` rather than being ignored.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence

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
    # wall time the request entered a slot; admitted - arrival is queue delay
    admitted: float = -1.0


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

    Admission reserves a slot's worst case so that ``cover()`` — which hands
    out physical pages lazily as the slot's position grows — always succeeds
    within the reservation. No page is held by two slots, and a full drain
    returns every page to the free list.
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
        """Pages promised to live slots (held now or claimable later)."""
        return sum(self._reserved.values())

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_of(self, slot: Any) -> List[int]:
        return list(self._pages.get(slot, ()))

    def can_reserve(self, n_positions: int) -> bool:
        return self.committed + self.pages_needed(n_positions) <= self.n_pages

    def reserve(self, slot: Any, n_positions: int) -> None:
        """Admit ``slot``: commit its worst-case page count (no pages yet)."""
        if slot in self._reserved:
            raise ValueError(f"slot {slot} already live")
        need = self.pages_needed(n_positions)
        if self.committed + need > self.n_pages:
            raise ValueError(f"over-committed: {self.committed}+{need} "
                             f"> {self.n_pages}")
        self._reserved[slot] = need
        self._pages[slot] = []

    def cover(self, slot: Any, n_positions: int) -> List[int]:
        """Grow ``slot`` to cover positions [0, n); returns the new pages."""
        held = self._pages[slot]
        target = min(self.pages_needed(n_positions), self._reserved[slot])
        grown = []
        while len(held) < target:
            page = self._free.pop()
            grown.append(page)
            held.append(page)
        return grown

    def release(self, slot: Any) -> List[int]:
        """Return all of ``slot``'s pages to the free list."""
        pages = self._pages.pop(slot)
        del self._reserved[slot]
        self._free.extend(pages)
        return pages




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
                 prefix_cache: bool = False, swap: Optional[str] = None,
                 speculate: Optional[Any] = None, stream: bool = False):
        unported = {
            "page_size=None (the contiguous KV layout)": page_size is None,
            "stage_slots > 0 (in-segment admission)": bool(stage_slots),
            "admission='optimistic' (preemption)": admission == "optimistic",
            "prefix_cache": bool(prefix_cache),
            "swap": swap is not None,
            "speculate": speculate is not None,
            "stream": bool(stream),
        }
        missing = [k for k, on in unported.items() if on]
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(missing))
        if admission != "worstcase":
            raise ValueError(f"unknown admission mode {admission!r}")
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
        # chunked prefill restarts a slot from an empty decode state; the
        # audio and vlm families need encoder KV from prefill and admit
        # whole prompts, as in the JAX engine (whose moe family, not
        # ported, is clamped too)
        self.chunk_threshold = (chunk_threshold if cfg.family == "dense"
                                else None)
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
        self._out = torch.full((max_batch, decode_block), -1, **i32)
        self._step_i = torch.zeros((1,), dtype=torch.long,
                                   device=self.device)
        self._dcache = dict(self._cache, bt=self._bt_dev)
        self._graph: Optional[Any] = None
        self._graph_launches: Dict[str, int] = {}
        # host mirrors of rem, pos and plen: they set each segment's step
        # count and split its emitted tokens between the slots
        self._rem = np.zeros((max_batch,), np.int64)
        self._slot_pos = np.zeros((max_batch,), np.int64)
        self._plen = np.zeros((max_batch,), np.int64)
        self.stats: Dict[str, int] = {
            "decode_traces": 0, "prefill_dispatches": 0,
            "decode_dispatches": 0, "decode_steps": 0,
            "tokens_generated": 0, "admitted": 0, "chunk_admits": 0,
            "peak_concurrency": 0, "busy_slot_steps": 0,
            "bubble_slot_steps": 0, "graph_replays": 0,
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

    def _n_positions(self, r: Request) -> int:
        """KV positions a request writes: the prompt plus one per generated
        token except the last (never fed back)."""
        return len(r.prompt) + max(r.max_new_tokens, 1) - 1

    def _sync_bt(self) -> None:
        """Copy the host block table into its device buffer after a change."""
        if self._bt_stale:
            self._bt_dev.copy_(torch.from_numpy(self._bt))
            self._bt_stale = False

    # ------------------------------------------------------------------
    # the decode step: one body, captured on the card
    def _step_body(self) -> None:
        """One decode step of every slot on the device loop state, in place:
        the JAX engine's segment body without its staging ring and
        completion log. The captured graph on the card, the segment loop's
        body on the CPU."""
        tok, pos, rem = self._tok, self._pos, self._rem_dev
        active = rem > 0
        logits, _ = self.model.decode(self.params, self._dcache, tok, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        # chunked prefill: while prompt tokens remain, feed the next one
        # instead of the sampled token and emit nothing
        feeding = pos + 1 < self._plen_dev
        at = torch.clamp(pos.long() + 1, 0, self.max_len - 1)
        nxt = torch.where(feeding, torch.gather(self._pbuf, 1, at[:, None])
                          [:, 0], nxt)
        emits = active & ~feeding
        self._out.index_copy_(1, self._step_i,
                              nxt.masked_fill(~emits, -1)[:, None])
        tok.copy_(torch.where(active[:, None], nxt[:, None], tok))
        pos.copy_(torch.where(active, pos + 1, pos))
        rem.copy_(torch.where(emits, rem - 1, rem))
        self._step_i.add_(1)

    @contextmanager
    def _quiesced(self) -> Iterator[None]:
        """Every slot inactive and every block-table row at the sentinel
        inside the block, so a step's KV writes are dropped (the plain
        path) or land on the trash page, which the fused kernel drops;
        ``tok``, ``pos``, ``rem``, ``out``, the step counter and the block
        table are restored on exit."""
        saved = [(t, t.clone()) for t in (self._tok, self._pos,
                                          self._rem_dev, self._out,
                                          self._step_i, self._bt_dev)]
        self._rem_dev.zero_()
        self._bt_dev.fill_(self.n_pages)
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
        self.stats["prefill_dispatches"] += 1
        self.stats["admitted"] += m
        return firsts_np

    def _admit_chunk(self, r: Request, slot: int) -> None:
        """Chunked admission: no prefill dispatch. The prompt goes to the
        slot's row of the device prompt buffer, and the next segments feed
        it one token a step before the slot emits ``max_new`` greedy
        tokens. The dense family has no O(1) state to reset."""
        n = len(r.prompt)
        row = np.zeros((self.max_len,), np.int32)
        row[:n] = r.prompt
        max_new = max(r.max_new_tokens, 1)
        self._pbuf[slot] = torch.from_numpy(row).to(self.device)
        self._plen_dev[slot] = n
        self._pos[slot] = 0
        self._tok[slot, 0] = int(r.prompt[0])
        self._rem_dev[slot] = max_new
        self._plen[slot], self._slot_pos[slot], self._rem[slot] = \
            n, 0, max_new
        self.stats["chunk_admits"] += 1
        self.stats["admitted"] += 1

    # ------------------------------------------------------------------
    # open-loop core: submit / step / drain_completions
    @property
    def busy(self) -> bool:
        """True while any request is pending admission or mid-decode."""
        return bool(self._pending) or \
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
        """Fill free slots FIFO while the pool holds each head's worst case:
        prompts longer than ``chunk_threshold`` are seated for chunked
        prefill, the rest prefilled grouped by prompt bucket."""
        now = time.perf_counter()
        prefills = []
        while self._pending and self._free:
            r = self._pending[0]
            npos = self._n_positions(r)
            if not self._alloc.can_reserve(npos):
                break                       # FIFO: nothing jumps the line
            self._pending.popleft()
            slot = self._free.pop()
            self._alloc.reserve(slot, npos)
            r.admitted = now
            if self.chunk_threshold is not None and \
                    len(r.prompt) > self.chunk_threshold:
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

    def _retire_slot(self, slot: int, r: Request, now: float) -> None:
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

    def _decode_segment(self, n_steps: int) -> np.ndarray:
        """Run ``n_steps`` decode steps over every slot and return the
        emitted tokens (B, n_steps), -1 where a slot emitted nothing.

        The activity masks live on the device; the emitted tokens come
        back once, at the end — the segment's one host sync.
        """
        self._sync_bt()
        self._out.fill_(-1)
        self._step_i.zero_()
        self._run_steps(n_steps)
        return self._out[:, :n_steps].cpu().numpy().copy()

    def step(self) -> int:
        """One engine step: admit pending requests into free slots, run one
        decode segment, harvest finished slots. Returns the number of decode
        steps executed (0 when idle)."""
        if self.device.type == "cuda" and self._graph is None:
            self._capture()
        self._admit_pending()
        live = [s for s, r in enumerate(self._slot_req) if r is not None]
        if not live:
            return 0
        self.stats["peak_concurrency"] = max(
            self.stats["peak_concurrency"], len(live))
        # append pages ahead of the segment: a slot's pos advances by at
        # most decode_block before the next host boundary (the worst-case
        # reservation pre-funds every cover)
        for s in live:
            self._grow_slot(s, min(int(self._slot_pos[s]) + self.decode_block,
                                   self._n_positions(self._slot_req[s])))
        # steps each slot is active: its prompt tokens still to feed (a
        # chunked slot's), then its tokens still owed
        feed = np.maximum(self._plen - 1 - self._slot_pos, 0)
        need = feed + self._rem
        n_steps = int(min(self.decode_block, need[live].max()))
        self.stats["decode_dispatches"] += 1
        out = np.zeros((self.max_batch, 0), np.int32)
        if n_steps:
            t0 = time.perf_counter()
            out = self._decode_segment(n_steps)
            self.timing["decode_s"] += time.perf_counter() - t0
        busy = 0
        finished = []
        for s in live:
            n = int(min(need[s], n_steps))
            if n == 0:
                continue
            row = out[s, :n]
            self._gen[s].extend(int(x) for x in row[row >= 0])
            self._rem[s] -= n - min(int(feed[s]), n)
            self._slot_pos[s] += n
            busy += n
            if self._rem[s] == 0:
                finished.append((n - 1, s))     # (finishing step, slot)
        self.stats["decode_steps"] += n_steps
        self.stats["busy_slot_steps"] += busy
        self.stats["bubble_slot_steps"] += n_steps * self.max_batch - busy
        now = time.perf_counter()
        for _step, s in sorted(finished):
            self._retire_slot(s, self._slot_req[s], now)
            self._free.append(s)
        # a prefilled request with max_new == 1 is complete at admission
        for s, r in enumerate(self._slot_req):
            if r is not None and self._rem[s] == 0:
                self._retire_slot(s, r, now)
                self._free.append(s)
        return n_steps

    def drain_completions(self) -> List[Request]:
        """Return (and clear) the requests completed since the last drain."""
        out, self._completed = self._completed, []
        return out

    @property
    def occupancy(self) -> Dict[str, float]:
        """Slot-busy fraction over all decode segments so far."""
        busy = self.stats["busy_slot_steps"]
        bubble = self.stats["bubble_slot_steps"]
        total = busy + bubble
        return {"slot_busy_frac": busy / total if total else 0.0,
                "bubble_slot_steps": float(bubble),
                "segments": float(self.stats["decode_dispatches"])}

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
