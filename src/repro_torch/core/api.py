"""INFaaS user API (paper Table 1): typed, payload-carrying model-less
queries.

The model-less abstraction lets a developer state *requirements* at one of
three granularities and leaves variant choice to the system (paper §3.2).
This module exposes that contract as two types:

``QuerySpec`` — an immutable description of one query: a tagged target

    QuerySpec.variant(name)                          # expert granularity
    QuerySpec.arch(name, latency_ms=...)             # arch + SLO
    QuerySpec.usecase(task, dataset,                 # fully model-less
                      min_accuracy=..., latency_ms=...)

plus ``user`` (submitter, for multi-tenant access control), ``mode``
("online" | "offline" best-effort), and an optional ``payload`` of real
inputs — token-id prompts with a ``max_new_tokens`` budget. Payload-
carrying specs served by a ``backend="real"`` cluster run their actual
prompts through the continuous-batching ``ServingEngine``; without a
payload the worker accounts ``n_inputs`` synthetic inputs (the simulator's
contract). A spec is a value: re-dispatch after a failure, hedged
duplicates, and offline retries all *replay the spec* rather than
re-deriving the granularity from sentinel fields.

``QueryHandle`` — the future returned by ``submit(spec)``:

    h = api.submit(QuerySpec.arch("llama3.2-1b", latency_ms=100))
    res = h.result(timeout=60.0)     # pumps the event loop until done
    res.outputs                      # per-input generated token ids (real)
    res.queue, res.load, res.compute # per-stage latency breakdown
    res.slo_met                      # SLO verdict (None when no SLO)

``done`` / ``add_done_callback`` give the non-blocking form; callbacks fire
in registration order, immediately if the handle already completed.

The pre-redesign kwargs forms (``online_query(mod_arch=..., ...)`` /
``offline_query(...)``) survive as thin deprecation shims over
``QuerySpec`` — they build the equivalent spec, submit it, and return the
raw ``Query`` / ``OfflineJob``, so existing call sites behave identically.

Also here: ``register_model(modelBinary/cfg, submitter, isPrivate)`` and
``model_info(task, dataset, accuracy)`` from Table 1.
"""
from __future__ import annotations

import dataclasses
import threading
import traceback
import warnings
from typing import (TYPE_CHECKING, Any, Callable, Dict, Iterator, List,
                    Optional, Sequence, Tuple, Union)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.worker import OfflineJob, Query

if TYPE_CHECKING:                                    # no runtime cycle:
    from repro_torch.core.master import Master             # master imports us


# ----------------------------------------------------------------------
# the tagged target: exactly one of the three granularities
@dataclasses.dataclass(frozen=True)
class VariantTarget:
    """Expert granularity: the user names the exact model-variant. ``slo``
    is not used for selection (the variant is pinned) but still yields the
    SLO verdict on the result."""
    name: str
    slo: Optional[float] = None      # seconds

    granularity = "variant"


@dataclasses.dataclass(frozen=True)
class ArchTarget:
    """Architecture granularity: the system picks the variant."""
    name: str
    slo: Optional[float] = None      # seconds

    granularity = "arch"


@dataclasses.dataclass(frozen=True)
class UseCaseTarget:
    """Fully model-less: (task, dataset, min accuracy) -> the system picks
    architecture and variant."""
    task: str
    dataset: str
    min_accuracy: float = 0.0
    slo: Optional[float] = None      # seconds

    granularity = "usecase"


Target = Union[VariantTarget, ArchTarget, UseCaseTarget]


def _slo_seconds(slo: Optional[float],
                 latency_ms: Optional[float]) -> Optional[float]:
    if slo is not None and latency_ms is not None:
        raise ValueError("give slo (seconds) or latency_ms, not both")
    if latency_ms is not None:
        return latency_ms / 1e3
    return slo


@dataclasses.dataclass(frozen=True)
class QueryPayload:
    """Real inputs for a query: token-id prompts + a decode budget.

    Stored as nested tuples so the spec stays immutable/hashable; use
    ``QueryPayload.of(...)`` to build one from lists / numpy arrays. On a
    ``backend="real"`` cluster each prompt becomes one
    ``serving.engine.Request`` and the generated token ids come back as
    ``QueryResult.outputs`` (one array per prompt, submission order). The
    engine enforces ``len(prompt) + max_new_tokens <= max_len``.
    """
    prompts: Tuple[Tuple[int, ...], ...]
    max_new_tokens: int = 4

    def __post_init__(self):
        if not self.prompts:
            raise ValueError("payload needs at least one prompt")
        if any(len(p) == 0 for p in self.prompts):
            raise ValueError("payload prompts must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @classmethod
    def of(cls, prompts: Sequence[Sequence[int]],
           max_new_tokens: int = 4) -> "QueryPayload":
        return cls(tuple(tuple(int(t) for t in p) for p in prompts),
                   max_new_tokens=max_new_tokens)

    def __len__(self) -> int:
        return len(self.prompts)


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One immutable query: tagged target + user + mode + optional payload.

    ``n_inputs`` is the batch the control plane accounts for; with a
    payload it must equal ``len(payload)`` (constructors derive it).
    Offline mode is best-effort and therefore rejects targets with an SLO
    (paper §3.2: offline has no latency option).
    """
    target: Target
    user: str = "public"
    mode: str = "online"             # "online" | "offline"
    n_inputs: int = 1
    payload: Optional[QueryPayload] = None

    def __post_init__(self):
        if not isinstance(self.target,
                          (VariantTarget, ArchTarget, UseCaseTarget)):
            raise TypeError(
                f"target must be one of VariantTarget | ArchTarget | "
                f"UseCaseTarget, got {type(self.target).__name__}")
        if self.mode not in ("online", "offline"):
            raise ValueError(f"mode must be online|offline, got {self.mode!r}")
        if self.mode == "offline" and self.target.slo is not None:
            raise ValueError("offline queries are best-effort: no SLO "
                             "(paper Table 1 has no offline latency option)")
        if self.n_inputs < 1:
            raise ValueError("n_inputs must be >= 1")
        if self.payload is not None and self.n_inputs != len(self.payload):
            raise ValueError(
                f"n_inputs={self.n_inputs} != len(payload)="
                f"{len(self.payload)}: one accounted input per prompt")

    # -- constructors (one per granularity) ----------------------------
    @classmethod
    def variant(cls, name: str, *, slo: Optional[float] = None,
                latency_ms: Optional[float] = None, user: str = "public",
                mode: str = "online", n_inputs: Optional[int] = None,
                payload: Optional[QueryPayload] = None) -> "QuerySpec":
        return cls(VariantTarget(name, _slo_seconds(slo, latency_ms)),
                   user=user, mode=mode,
                   n_inputs=cls._n(n_inputs, payload), payload=payload)

    @classmethod
    def arch(cls, name: str, *, slo: Optional[float] = None,
             latency_ms: Optional[float] = None, user: str = "public",
             mode: str = "online", n_inputs: Optional[int] = None,
             payload: Optional[QueryPayload] = None) -> "QuerySpec":
        return cls(ArchTarget(name, _slo_seconds(slo, latency_ms)),
                   user=user, mode=mode,
                   n_inputs=cls._n(n_inputs, payload), payload=payload)

    @classmethod
    def usecase(cls, task: str, dataset: str, *, min_accuracy: float = 0.0,
                slo: Optional[float] = None,
                latency_ms: Optional[float] = None, user: str = "public",
                mode: str = "online", n_inputs: Optional[int] = None,
                payload: Optional[QueryPayload] = None) -> "QuerySpec":
        return cls(UseCaseTarget(task, dataset, min_accuracy,
                                 _slo_seconds(slo, latency_ms)),
                   user=user, mode=mode,
                   n_inputs=cls._n(n_inputs, payload), payload=payload)

    @staticmethod
    def _n(n_inputs: Optional[int], payload: Optional[QueryPayload]) -> int:
        if n_inputs is None:
            return len(payload) if payload is not None else 1
        return n_inputs

    # -- views ----------------------------------------------------------
    @property
    def granularity(self) -> str:
        return self.target.granularity

    @property
    def slo(self) -> Optional[float]:
        return self.target.slo


@dataclasses.dataclass
class QueryResult:
    """Completed-query view handed out by ``QueryHandle.result()``."""
    ok: bool                          # finished and not failed
    failed: bool
    outputs: Optional[List[Any]]      # per-input token-id arrays (real
    #                                   backend with payload), else None
    latency: float                    # arrival -> finish, seconds
    queue: float                      # waiting for a device slot
    load: float                       # variant load time this query paid
    compute: float                    # service time on the device
    slo: Optional[float]
    slo_met: Optional[bool]           # None when the spec carried no SLO
    variant: str
    worker: str
    processed: int = 0                # offline: inputs completed
    total: int = 0                    # offline: inputs requested
    # served correctly but on borrowed time: some of the query's work was
    # preempted under KV memory pressure and recovered bit-identically
    # (outputs are unaffected; latency absorbed the replay)
    degraded: bool = False
    # dispatch attempts the master burned placing this query (1 = first
    # try; >1 = retried with exponential backoff after failures)
    attempts: int = 0
    # deadline enforcement: the engine cancelled this query's generation
    # past its SLO deadline. ``outputs`` then holds the tokens decoded
    # before the cutoff (possibly none); ``slo_met`` is False.
    timed_out: bool = False


@dataclasses.dataclass(frozen=True)
class TokenChunk:
    """One streamed batch of generated tokens for a handle's query.

    ``input_idx`` names which payload prompt the tokens extend (chunks of
    one prompt arrive in emission order; concatenating their ``tokens``
    reproduces that prompt's final output exactly). ``t`` is the clock
    time the chunk was harvested (wall seconds under ``RealClock``)."""
    input_idx: int
    tokens: Tuple[int, ...]
    t: float


class QueryHandle:
    """Future for one submitted ``QuerySpec`` (online query or offline job).

    ``result(timeout=...)`` blocks until the query completes: under a
    virtual clock it pumps the cluster's event loop (so a client never
    needs to guess a ``run_until`` horizon), under ``RealClock`` it waits
    on a condition variable that the control plane notifies at completion.
    ``add_done_callback(fn)`` registers ``fn(handle)``; callbacks run in
    registration order, immediately if already done. Completion is
    idempotent — a hedged duplicate finishing after its winner cannot
    re-fire the handle.

    Streaming (real backend with ``stream`` enabled): ``on_tokens(cb)``
    fires ``cb(TokenChunk)`` as decode segments retire (already-received
    chunks are replayed at registration, so late registration never loses
    tokens), ``iter_tokens()`` yields the same chunks as a generator, and
    ``ttft`` reports time-to-first-token once the first chunk lands.
    Callbacks must not block: they run on the delivering thread under the
    handle's lock.
    """

    def __init__(self, spec: QuerySpec, loop,
                 query: Optional[Query] = None,
                 job: Optional[OfflineJob] = None):
        self.spec = spec
        self.query = query
        self.job = job
        self._loop = loop
        self._done = False
        self._snapshot: Optional[QueryResult] = None
        self._callbacks: List[Callable[["QueryHandle"], None]] = []
        # streaming state: chunks in emission order + registered sinks,
        # all guarded by one condition variable (reentrant so delivery
        # under the lock tolerates a cb registering another cb)
        self._cv = threading.Condition(threading.RLock())
        self._chunks: List[TokenChunk] = []
        self._token_cbs: List[Callable[[TokenChunk], None]] = []
        # per-input count of tokens already delivered downstream: a query
        # re-dispatched after a partial stream regenerates from token 0
        # on the new worker, and this cursor suppresses the re-sent
        # prefix so subscribers see each token exactly once
        self._stream_pos: Dict[int, int] = {}

    # -- completion machinery (driven by the master) --------------------
    def _complete(self, *_ignored) -> None:
        if self._done:
            return
        # snapshot now: a losing hedge copy finishing later mutates the
        # raw Query's finish/violated fields, and result() must keep
        # reporting the winner's latency and verdict
        self._snapshot = self._build_result()
        with self._cv:
            self._done = True
            self._cv.notify_all()
        for cb in self._callbacks:
            cb(self)
        self._callbacks.clear()

    def _push_tokens(self, input_idx: int, tokens, t: float,
                     start: Optional[int] = None) -> None:
        """Streaming sink the worker drives (via ``Query.on_tokens``):
        record the chunk, wake blocked iterators, fan out to callbacks.

        ``start`` is the chunk's absolute token offset within the input's
        output (each dispatch attempt counts from 0 as it regenerates).
        Tokens at offsets this handle already delivered — the replayed
        prefix of a retry on another worker, or a hedged duplicate racing
        the winner — are dropped, so concatenating the chunks of one
        input always reproduces its output exactly once. ``start=None``
        (legacy callers) keeps the old append-everything behavior."""
        toks = tuple(int(x) for x in tokens)
        idx = int(input_idx)
        with self._cv:
            if start is not None:
                seen = self._stream_pos.get(idx, 0)
                end = int(start) + len(toks)
                if end <= seen:
                    return              # fully re-sent: already delivered
                if start < seen:
                    toks = toks[seen - int(start):]   # trim the overlap
                self._stream_pos[idx] = end
            if not toks:
                return
            chunk = TokenChunk(idx, toks, float(t))
            self._chunks.append(chunk)
            self._cv.notify_all()
            for cb in list(self._token_cbs):
                try:
                    cb(chunk)
                except Exception:  # noqa: BLE001 - a broken subscriber
                    traceback.print_exc()   # must not fail the query

    # -- future surface --------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done

    def add_done_callback(self,
                          fn: Callable[["QueryHandle"], None]) -> None:
        if self._done:
            fn(self)
        else:
            self._callbacks.append(fn)

    def result(self, timeout: Optional[float] = None) -> QueryResult:
        """Block until done: pump the event loop under a virtual clock
        (``timeout`` is then in virtual seconds), or wait on the handle's
        condition variable under ``RealClock`` (wall seconds)."""
        loop = self._loop
        if not getattr(loop, "virtual", True):
            with self._cv:
                if not self._cv.wait_for(lambda: self._done, timeout):
                    raise TimeoutError(
                        f"query not done after {timeout}s of wall time")
            return self._snapshot
        deadline = None if timeout is None else loop.now() + timeout
        while not self._done:
            nxt = loop.next_event_time()
            if nxt is None:
                break                     # loop drained; nothing can finish
            if deadline is not None and nxt > deadline:
                loop.run_until(deadline)
                break
            loop.step()
        if not self._done:
            raise TimeoutError(
                f"query not done after pumping the loop to "
                f"t={loop.now():.3f}s (timeout={timeout})")
        return self._snapshot

    # -- streaming surface -----------------------------------------------
    def on_tokens(self, cb: Callable[[TokenChunk], None]) -> None:
        """Register a streaming sink; chunks already received are replayed
        first (in order), then every future chunk fires ``cb`` as it
        lands. Requires the query to have been submitted with streaming
        enabled (real backend, ``stream`` on) to ever fire."""
        with self._cv:
            for chunk in self._chunks:
                cb(chunk)
            self._token_cbs.append(cb)

    def iter_tokens(self,
                    timeout: Optional[float] = None) -> Iterator[TokenChunk]:
        """Yield ``TokenChunk``s in emission order until the query
        completes. Under a virtual clock this pumps the event loop between
        chunks; under ``RealClock`` it blocks on the condition variable.
        ``timeout`` bounds the *total* iteration time."""
        loop = self._loop
        deadline = None if timeout is None else loop.now() + timeout
        i = 0
        while True:
            with self._cv:
                pending = self._chunks[i:]
                i = len(self._chunks)
                done = self._done
            for chunk in pending:
                yield chunk
            if done:
                return
            if deadline is not None and loop.now() >= deadline:
                raise TimeoutError(
                    f"query still streaming after timeout={timeout}s")
            if getattr(loop, "virtual", True):
                if not loop.step():
                    return             # loop drained; nothing can finish
            else:
                with self._cv:
                    self._cv.wait_for(
                        lambda: self._done or len(self._chunks) > i,
                        timeout=None if deadline is None
                        else max(deadline - loop.now(), 0.0))

    @property
    def chunks(self) -> List[TokenChunk]:
        """Chunks received so far (emission order), without blocking."""
        with self._cv:
            return list(self._chunks)

    @property
    def ttft(self) -> Optional[float]:
        """Time-to-first-token in clock seconds (first streamed chunk's
        harvest time minus arrival); None until the first chunk lands or
        when the query never streamed."""
        q = self.query
        if q is None or q.first_token < 0.0:
            return None
        return q.first_token - q.arrival

    # -- completed-state views -------------------------------------------
    def _build_result(self) -> QueryResult:
        if self.job is not None:
            j = self.job
            return QueryResult(
                ok=j.done and not j.failed, failed=j.failed,
                outputs=j.outputs or None,
                latency=(j.finish - j.arrival) if j.finish >= 0 else -1.0,
                queue=0.0, load=0.0, compute=0.0,
                slo=None, slo_met=None, variant=j.variant, worker="",
                processed=j.processed, total=j.total_inputs,
                degraded=j.degraded, attempts=j.attempts,
                timed_out=False)
        q = self.query
        queue, load, compute = self.breakdown
        return QueryResult(
            ok=q.finish >= 0 and not q.failed, failed=q.failed,
            outputs=q.outputs, latency=q.latency,
            queue=queue, load=load, compute=compute,
            slo=q.slo, slo_met=self.slo_met,
            variant=q.variant, worker=q.worker,
            degraded=q.degraded, attempts=q.attempts,
            timed_out=q.timed_out)

    @property
    def breakdown(self) -> Tuple[float, float, float]:
        """(queue, load, compute) seconds; queue+load+compute == latency."""
        q = self.query
        if q is None or q.finish < 0 or q.start < 0:
            return (0.0, 0.0, 0.0)
        compute = q.finish - q.start
        load = min(q.load_wait, q.start - q.arrival)
        queue = max(q.start - q.arrival - load, 0.0)
        return (queue, load, compute)

    @property
    def slo_met(self) -> Optional[bool]:
        """SLO verdict: None when the spec carried no SLO or the query is
        not done, else whether latency stayed within it."""
        q = self.query
        if q is None or q.slo is None or q.finish < 0:
            return None
        return not q.violated


# ----------------------------------------------------------------------
class INFaaS:
    """Table-1 facade over the master."""

    def __init__(self, master: "Master"):
        self.master = master

    # ------------------------------------------------------------------
    def register_model(self, model_cfg: ArchConfig, *, submitter: str,
                       is_private: bool = False,
                       accuracy: Optional[float] = None) -> Dict[str, Any]:
        n = self.master.register_model(model_cfg, submitter=submitter,
                                       is_private=is_private,
                                       accuracy=accuracy)
        return {"status": "ok", "arch": model_cfg.name, "num_variants": n}

    # ------------------------------------------------------------------
    def model_info(self, *, task: Optional[str] = None,
                   dataset: Optional[str] = None, accuracy: float = 0.0,
                   submitter: str = "public") -> List[Dict[str, Any]]:
        reg = self.master.store.registry
        out = []
        for a in reg.archs.values():
            if task and a.task != task:
                continue
            if dataset and a.dataset != dataset:
                continue
            if a.accuracy < accuracy or not a.accessible_by(submitter):
                continue
            out.append({
                "arch": a.name, "task": a.task, "dataset": a.dataset,
                "accuracy": a.accuracy,
                "variants": [
                    {"name": v.name, "hardware": v.hardware,
                     "batch": v.batch_opt,
                     "latency_b1_ms": v.profile.latency(1) * 1e3,
                     "load_ms": v.profile.load_latency * 1e3,
                     "mem_mb": v.profile.peak_memory / 2**20}
                    for v in reg.variants_of(a.name)],
            })
        return out

    # ------------------------------------------------------------------
    def submit(self, spec: QuerySpec) -> QueryHandle:
        """The model-less query call: one path for every granularity and
        both modes. Returns a ``QueryHandle`` future."""
        return self.master.submit(spec)

    # -- deprecated kwargs forms (thin shims over QuerySpec) -------------
    def online_query(self, *, submitter: str = "public", n_inputs: int = 1,
                     mod_var: Optional[str] = None,
                     mod_arch: Optional[str] = None,
                     task: Optional[str] = None,
                     dataset: Optional[str] = None,
                     accuracy: float = 0.0,
                     latency_ms: Optional[float] = None,
                     done_cb=None) -> Query:
        """Deprecated: build a ``QuerySpec`` and call ``submit``."""
        warnings.warn("INFaaS.online_query(**kwargs) is deprecated; "
                      "use submit(QuerySpec...)", DeprecationWarning,
                      stacklevel=2)
        spec = _spec_from_kwargs(
            mode="online", variant=mod_var, arch=mod_arch, task=task,
            dataset=dataset, accuracy=accuracy,
            slo=latency_ms / 1e3 if latency_ms is not None else None,
            user=submitter, n_inputs=n_inputs)
        h = self.master.submit(spec)
        if done_cb is not None:
            h.add_done_callback(lambda hh: done_cb(hh.query))
        return h.query

    def offline_query(self, *, submitter: str = "public", n_inputs: int,
                      mod_var: Optional[str] = None,
                      mod_arch: Optional[str] = None,
                      task: Optional[str] = None,
                      dataset: Optional[str] = None, accuracy: float = 0.0,
                      done_cb=None) -> OfflineJob:
        """Deprecated: build an offline ``QuerySpec`` and call ``submit``.
        (Input/output object-store paths are validated by the real system;
        here ``n_inputs`` stands in for the staged input set.) The legacy
        form always selected as the public user — preserved here;
        spec-built offline queries honor ``user`` for access control."""
        warnings.warn("INFaaS.offline_query(**kwargs) is deprecated; "
                      "use submit(QuerySpec(..., mode='offline'))",
                      DeprecationWarning, stacklevel=2)
        del submitter                 # legacy behavior: never forwarded
        spec = _spec_from_kwargs(
            mode="offline", variant=mod_var, arch=mod_arch, task=task,
            dataset=dataset, accuracy=accuracy, slo=None, user="public",
            n_inputs=n_inputs)
        h = self.master.submit(spec)
        if done_cb is not None:
            h.add_done_callback(lambda hh: done_cb(hh.job))
        return h.job


def _spec_from_kwargs(*, mode: str, variant: Optional[str],
                      arch: Optional[str], task: Optional[str],
                      dataset: Optional[str], accuracy: float,
                      slo: Optional[float], user: str,
                      n_inputs: int) -> QuerySpec:
    """Granularity resolution of the legacy kwargs forms (variant wins,
    then arch, else use-case) — shared by the facade and master shims."""
    if variant is not None:
        target: Target = VariantTarget(variant, slo)
    elif arch is not None:
        target = ArchTarget(arch, slo)
    else:
        target = UseCaseTarget(task or "", dataset or "", accuracy, slo)
    return QuerySpec(target, user=user, mode=mode, n_inputs=n_inputs)
