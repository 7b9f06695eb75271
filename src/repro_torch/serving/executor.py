"""EngineExecutor: the real data plane behind an INFaaS worker device
(the port of ``repro.serving.executor``).

Implements the worker's ``Executor`` protocol (``repro_torch.core.worker``)
over per-variant continuous-batching ``ServingEngine`` instances, so the
whole control plane — per-query variant selection, adaptive batching, the
monitoring daemon, and two-level autoscaling — drives *live* engines
instead of the profile-driven simulation:

* ``run(variant, batch, requests)`` builds (lazily) an engine for the
  variant, pushes the batch through the open-loop
  ``submit()``/``step()``/``drain_completions()`` core, and returns the
  measured wall-clock service time. That measured time becomes the job's
  duration on the worker's (virtual) clock, so queueing, utilization, and
  autoscaling decisions all reflect real execution speed.

* each ``ExecRequest`` in ``requests`` is one co-batched query: when it
  carries real payload prompts, every prompt becomes one
  ``serving.engine.Request`` and the generated token ids are handed back
  through the request's ``on_outputs`` sink (one array per prompt, in
  submission order). Requests without prompts fall back to the synthetic
  shape (``prompt_len``/``max_new`` below).

* every synthetic measurement is recorded per batch size, and once two
  distinct batch sizes have been observed the variant's ``VariantProfile``
  is re-fit in place (``repro_torch.core.profiler.refit_profile``):
  t(b) = m*b + c moves from the analytic roofline guess to calibrated
  reality.

The executor holds one ``device`` (default ``"cuda"``) and runs every
variant there, whatever its hardware label, as ``repro``'s executor runs
every variant on its one JAX device. Model weights are built once per
architecture (``build_model(cfg.for_device(device), device)`` and
``model.init(seed)``; int8 variants quantize the fp tree with
``models.quantize.quantize_params_dense``) and shared across the variants
and, via ``model_cache``, across the cluster's workers; each variant gets
its own engine so slot state never crosses variants. Engines are warmed up
at creation — on the card that builds the kernels with ``nvcc`` and
captures the decode step's CUDA graph — keeping both out of the measured
service times. With ``max_engines`` set,
the per-variant engine map is an LRU.

The port's engine pages its KV cache and refuses the contiguous layout, so
``page_size`` defaults to 16 here (``repro``'s default ``None`` is the
contiguous layout). ``chunk_threshold``, ``stage_slots``, ``admission``,
``preempt_policy`` and ``stream`` reach every engine (the engine clamps the
first three off for the audio and vlm families): chunked prefill,
in-segment admission and optimistic admission with preemption run under
the full control plane. ``ExecRequest.slo`` reaches each engine
``Request``, for the slack policy's victim choice; each run's record in
``occupancy_log`` (the executor's decision log) carries its slot-busy
fraction, in-segment admissions per segment, preemptions and pressure
stalls; ``on_report`` says whether a query's work was preempted or cut
short; with ``stream`` set, each step's partial outputs go to the
queries' ``on_tokens`` sinks. The knobs this slice lacks — the prefix
cache and its eviction policy, speculation, host swap, deadline
enforcement (only the wall-clock runtime, not ported, calls
``cancel_overdue``) and the threaded runtime's fault sites — raise
``NotImplementedError`` by name when the executor is built.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import profiler as prof
from repro_torch.core.abstraction import Variant
from repro_torch.core.worker import ExecRequest
from repro_torch.serving.engine import Request, ServingEngine


@dataclasses.dataclass
class EngineExecutorConfig:
    """Engine geometry + synthetic request shape for real execution."""
    max_batch: int = 4          # engine slots (admission queues past this)
    max_len: int = 32
    decode_block: int = 4
    min_bucket: int = 4
    prompt_len: int = 6         # synthetic request shape (fixed -> one
    max_new: int = 3            # prefill bucket)
    refit_min_points: int = 2   # distinct batch sizes before an m,c refit
    obs_window: int = 32        # measurements kept per (variant, batch)
    seed: int = 0
    page_size: int = 16               # paged KV cache (the only layout)
    n_pages: Optional[int] = None     # pool size (None = slot parity)
    chunk_threshold: Optional[int] = None  # chunked prefill past this len
    max_engines: Optional[int] = None  # LRU cap on live engines (None = off)
    stage_slots: int = 0              # in-segment admission ring (0 = off)
    admission: str = "worstcase"      # page admission: worstcase|optimistic
    preempt_policy: str = "slack"     # pressure victim choice: slack|lru
    prefix_cache: bool = False        # page-granular prompt-prefix sharing
    prefix_evict: str = "lru"         # cached-page eviction: lru|fifo
    stream: bool = False              # per-segment partial outputs
    quantize: str = "none"            # "int8": serve every dense-family
    #                                   engine with weight-only int8 params
    #                                   (torch-int8 variants quantize even
    #                                   when this stays "none")
    speculate: Optional[str] = None   # "DRAFT:K": speculative decoding
    swap: Optional[str] = None        # "host": preempted KV pages to host
    swap_budget_bytes: Optional[int] = None  # cap on parked swap payloads
    deadline_enforce: bool = False    # cancel slots past their deadline
    faults: Optional[Any] = None      # the threaded runtime's fault sites

    def unported(self) -> List[str]:
        """The knobs set away from their defaults that this slice lacks."""
        knobs = {
            "prefix_cache": bool(self.prefix_cache),
            f"prefix_evict={self.prefix_evict!r}":
                self.prefix_evict != "lru",
            "speculate": self.speculate is not None,
            "swap": self.swap is not None,
            "swap_budget_bytes": self.swap_budget_bytes is not None,
            "deadline_enforce": bool(self.deadline_enforce),
            "faults (the threaded runtime's fault sites)":
                self.faults is not None,
        }
        return [k for k, on in knobs.items() if on]


class EngineExecutor:
    """Real executor: worker jobs run on per-variant ``ServingEngine``s.

    ``arch_cfgs`` maps architecture name -> ``ArchConfig`` (full width on
    the card, ``reduced()`` on the CPU); pass a shared ``model_cache`` dict
    to reuse built params across executors (one per worker) in the same
    cluster. ``device`` is where every engine runs (default CUDA; raises
    without it).
    """

    def __init__(self, arch_cfgs: Dict[str, ArchConfig],
                 cfg: EngineExecutorConfig = EngineExecutorConfig(),
                 model_cache: Optional[Dict[str, Tuple[Any, Any]]] = None,
                 device="cuda"):
        missing = cfg.unported()
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(missing))
        if cfg.quantize not in ("none", "int8"):
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
        self.device = resolve_device(device)
        self.arch_cfgs = dict(arch_cfgs)
        self.cfg = cfg
        self.engines: Dict[str, ServingEngine] = {}      # by variant name
        # bounded per-(variant, batch) history: refits stay O(obs_window)
        # per job and memory stays flat in a long-running cluster
        self.observations: Dict[str, Dict[int, Deque[float]]] = {}
        self.refits: Dict[str, int] = {}                 # refit count
        self.evictions = 0                               # LRU engine drops
        # per-run occupancy records (the executor's decision log), bounded
        # like `observations`
        self.occupancy_log: Deque[Dict[str, Any]] = \
            deque(maxlen=max(cfg.obs_window * 8, 256))
        # monotone total of pressure events (preemptions + stalls) ever
        # logged: the bounded log above drops its oldest entries
        self.pressure_events_total: float = 0.0
        self._models = model_cache if model_cache is not None else {}
        self._rid = itertools.count()
        # serializes run() (engines, observations, occupancy_log)
        self._lock = threading.RLock()

    # ------------------------------------------------------------------
    def _model(self, arch: str, quantize: str = "none"):
        key = arch if quantize == "none" else f"{arch}::{quantize}"
        entry = self._models.get(key)
        if entry is None:
            from repro_torch.models.model import build_model
            cfg = self.arch_cfgs[arch]
            if quantize == "none":
                model = build_model(cfg.for_device(self.device), self.device)
                params = model.init(self.cfg.seed)
            else:
                # quantized variants share the fp build's weights: the int8
                # tree is derived from the arch's params, so the fp/int8
                # pair differ only by per-channel weight rounding — the
                # accuracy/latency axis selection trades over
                from repro_torch.models.quantize import quantize_params_dense
                _, base_params = self._model(arch)
                model = build_model(
                    dataclasses.replace(cfg, quantize=quantize).for_device(
                        self.device), self.device)
                params = quantize_params_dense(base_params)
            entry = (model, params)
            self._models[key] = entry
        return entry

    def served_model(self, variant: Variant):
        """(model, params) the variant's engine serves: the int8 tree for a
        dense ``torch-int8`` variant (or a blanket ``quantize="int8"``),
        the fp tree otherwise."""
        arch_cfg = self.arch_cfgs[variant.arch]
        use_int8 = (arch_cfg.family == "dense"
                    and (variant.framework == "torch-int8"
                         or self.cfg.quantize == "int8"))
        return self._model(variant.arch, "int8" if use_int8 else "none")

    def _engine(self, variant: Variant) -> ServingEngine:
        eng = self.engines.pop(variant.name, None)
        if eng is None:
            if self.cfg.max_engines is not None:
                # LRU cap: engines are idle between run() calls, so
                # eviction never drops in-flight state; an evicted variant
                # rebuilds lazily here and re-warms before the measured
                # window.
                while len(self.engines) >= max(self.cfg.max_engines, 1):
                    victim = next(iter(self.engines))
                    del self.engines[victim]
                    self.evictions += 1
            model, params = self.served_model(variant)
            eng = ServingEngine(
                model, params,
                max_batch=min(self.cfg.max_batch,
                              max(variant.profile.max_batch, 1)),
                max_len=self.cfg.max_len,
                decode_block=self.cfg.decode_block,
                min_bucket=self.cfg.min_bucket,
                page_size=self.cfg.page_size,
                n_pages=self.cfg.n_pages,
                chunk_threshold=self.cfg.chunk_threshold,
                stage_slots=self.cfg.stage_slots,
                admission=self.cfg.admission,
                preempt_policy=self.cfg.preempt_policy,
                stream=self.cfg.stream)
            eng.warmup(prompt_lens=[self.cfg.prompt_len])
        # dict order doubles as the LRU list: reinsert on every access
        self.engines[variant.name] = eng
        return eng

    # ------------------------------------------------------------------
    def _synthetic_prompt(self, vocab: int) -> np.ndarray:
        return (np.arange(self.cfg.prompt_len, dtype=np.int64)
                % vocab).astype(np.int32)

    _OCC_KEYS = ("busy_slot_steps", "bubble_slot_steps",
                 "inseg_admissions", "decode_dispatches", "preemptions",
                 "pressure_stalls")

    def _make_requests(self, er: ExecRequest, vocab: int,
                       t0: float) -> List[Request]:
        """One engine Request per payload prompt (or synthetic stand-in)."""
        if er.prompts:
            return [Request(rid=next(self._rid),
                            prompt=np.asarray(p, np.int32),
                            max_new_tokens=max(er.max_new_tokens, 1),
                            arrival=t0, slo=er.slo)
                    for p in er.prompts]
        return [Request(rid=next(self._rid),
                        prompt=self._synthetic_prompt(vocab),
                        max_new_tokens=self.cfg.max_new, arrival=t0,
                        slo=er.slo)
                for _ in range(max(er.n_inputs, 1))]

    @staticmethod
    def _pump_stream(eng: ServingEngine,
                     sinks: Dict[int, Tuple[ExecRequest, int]]) -> int:
        """Forward freshly harvested partial outputs to their queries'
        ``on_tokens`` sinks (no-op on non-streaming engines). Returns the
        number of chunks delivered."""
        if not eng.stream:
            return 0
        n = 0
        for r, toks, t in eng.drain_partial_outputs():
            ent = sinks.get(id(r))
            if ent is not None:
                er, idx = ent
                if er.on_tokens is not None:
                    er.on_tokens(idx, toks, t)
                    n += 1
        return n

    def _record_occupancy(self, variant: Variant, batch: int, dt: float,
                          occ0: Dict[str, int],
                          eng: ServingEngine) -> None:
        # decision-log entry: per-run occupancy of the decode segments and
        # what the packing cost in preempted work
        d = {k: eng.stats.get(k, 0) - occ0[k] for k in occ0}
        total = d["busy_slot_steps"] + d["bubble_slot_steps"]
        segs = d["decode_dispatches"]
        self.occupancy_log.append({
            "variant": variant.name, "batch": int(batch),
            "service_s": dt, "segments": segs,
            "slot_busy_frac":
                d["busy_slot_steps"] / total if total else 0.0,
            "admissions_per_segment":
                d["inseg_admissions"] / segs if segs else 0.0,
            "bubble_slot_steps": d["bubble_slot_steps"],
            "preemptions": d["preemptions"],
            "pressure_stalls": d["pressure_stalls"],
        })
        self.pressure_events_total += \
            d["preemptions"] + d["pressure_stalls"]

    @staticmethod
    def _deliver(er: ExecRequest, ers: List[Request]) -> None:
        """Hand a finished group's tokens and degradation report back: a
        query whose requests were preempted (and recovered) completed
        degraded, one cut short timed out."""
        if er.on_outputs is not None:
            er.on_outputs([np.asarray(r.tokens, np.int32) for r in ers])
        if er.on_report is not None:
            npre = sum(r.preemptions for r in ers)
            er.on_report({"preemptions": npre, "degraded": npre > 0,
                          "timed_out": any(r.cancelled for r in ers)})

    def _observe(self, variant: Variant, n: int, dt: float) -> None:
        """Fold one synthetic-batch measurement into the t(b) fit."""
        obs = self.observations.setdefault(variant.name, {})
        obs.setdefault(n, deque(maxlen=self.cfg.obs_window)).append(dt)
        if prof.refit_profile(variant.profile, obs,
                              min_points=self.cfg.refit_min_points):
            self.refits[variant.name] = \
                self.refits.get(variant.name, 0) + 1

    def run(self, variant: Variant, batch: int,
            requests: Optional[List[ExecRequest]] = None) -> float:
        """Serve one batch for real — each ExecRequest's payload prompts
        (or synthetic stand-ins) become engine Requests; return the
        measured service time, hand generated tokens back through each
        request's ``on_outputs`` sink, and fold the measurement into the
        variant's profile. With ``cfg.stream`` set, partial outputs go to
        each request's ``on_tokens`` sink after every engine step."""
        with self._lock:
            eng = self._engine(variant)
            vocab = self.arch_cfgs[variant.arch].vocab
            if not requests:
                requests = [ExecRequest(n_inputs=max(int(batch), 1))]
            # warm any new prompt bucket outside the measured window, so a
            # first-seen payload length doesn't bill its first prefill as
            # service time
            real_lens = [len(p) for er in requests for p in er.prompts]
            if real_lens:
                eng.warmup(prompt_lens=real_lens)
            groups: List[Tuple[ExecRequest, List[Request]]] = []
            # .get: a duck-typed engine stand-in need not carry every
            # counter (absent == zero)
            occ0 = {k: eng.stats.get(k, 0) for k in self._OCC_KEYS}
            t0 = time.perf_counter()
            sinks: Dict[int, Tuple[ExecRequest, int]] = {}
            for er in requests:
                ers = self._make_requests(er, vocab, t0)
                for i, r in enumerate(ers):
                    eng.submit(r)
                    sinks[id(r)] = (er, i)
                groups.append((er, ers))
            # every engine step ends in its host sync, so dt covers the
            # device work
            while eng.busy:
                eng.step()
                self._pump_stream(eng, sinks)
            eng.drain_completions()
            dt = time.perf_counter() - t0
            self._record_occupancy(variant, batch, dt, occ0, eng)
            for er, ers in groups:
                self._deliver(er, ers)
            # only synthetic runs calibrate t(b): they share one fixed
            # (prompt_len, max_new) shape, so duration varies with batch
            # count alone. Payload runs have arbitrary prompt/decode shapes
            # and would corrupt the shared m/c fit that selection and
            # autoscaling plan with.
            if not any(er.prompts for er in requests):
                n = max(sum(len(ers) for _, ers in groups), 1)
                self._observe(variant, n, dt)
            return dt
