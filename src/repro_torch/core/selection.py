"""Model-variant selection (paper §5, Algorithm 1) with the decision cache.

Three outcomes, in order:
  1. decision cache hit and the cached variant is running & not overloaded;
  2. scan of the architecture's variants for a running, valid, non-overloaded
     one (use-case queries scan the top-N=7 accuracy-qualified variants);
  3. pick the variant minimizing (load latency + inference latency) and load
     it on the least-utilized worker with the target hardware.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.abstraction import Variant
from repro_torch.core.metadata import InstanceState, MetadataStore
from repro_torch.sim import hardware as HW


@dataclasses.dataclass
class Selection:
    variant: Optional[Variant]
    worker: Optional[str]
    needs_load: bool
    outcome: str          # "cache" | "running" | "load" | "reject"
    reason: str = ""


def _is_valid(v: Variant, batch: int, latency_slo: Optional[float]) -> bool:
    if batch > v.profile.max_batch:
        return False
    if latency_slo is not None and v.profile.latency(batch) > latency_slo:
        return False
    return True


class VariantSelector:
    def __init__(self, store: MetadataStore, top_n: int = 7):
        self.store = store
        self.top_n = top_n
        self._cache = {}   # key -> variant name

    # ------------------------------------------------------------------
    def _least_loaded_worker(self, insts: List[InstanceState]) -> InstanceState:
        return min(insts, key=lambda i: i.qps)

    def _pick_running(self, cands: List[Variant], batch: int,
                      slo: Optional[float]) -> Optional[Selection]:
        for v in cands:
            if not _is_valid(v, batch, slo):
                continue
            insts = [i for i in self.store.running_instances_of(v.name)
                     if not self.store.is_overloaded(i)]
            if insts:
                inst = self._least_loaded_worker(insts)
                return Selection(v, inst.worker, False, "running")
        return None

    def _pick_load(self, cands: List[Variant], batch: int,
                   slo: Optional[float]) -> Selection:
        """Outcome 3: lowest combined loading+inference latency."""
        best: Optional[Tuple[float, Variant, str]] = None
        for v in cands:
            if batch > v.profile.max_batch:
                continue
            total = v.profile.load_latency + v.profile.latency(batch)
            if slo is not None and v.profile.latency(batch) > slo:
                # keep as fallback only: inference alone violates -> skip
                continue
            worker = self._worker_for_load(v)
            if worker is None:
                continue
            if best is None or total < best[0]:
                best = (total, v, worker)
        if best is None:
            # relax: allow any variant that fits the batch (paper falls back
            # to the lowest-latency option rather than rejecting outright)
            for v in sorted(cands, key=lambda x: x.profile.load_latency
                            + x.profile.latency(min(batch, x.profile.max_batch))):
                if batch > v.profile.max_batch:
                    continue
                worker = self._worker_for_load(v)
                if worker is not None:
                    return Selection(v, worker, True, "load",
                                     reason="slo-relaxed")
            return Selection(None, None, False, "reject",
                             reason="no feasible variant/worker")
        return Selection(best[1], best[2], True, "load")

    def _worker_for_load(self, v: Variant) -> Optional[str]:
        """Least-utilized live worker with the hardware + free memory."""
        best = None
        for w in self.store.workers.values():
            if not w.alive or w.blacklisted or v.hardware not in w.hardware:
                continue
            cap = HW.HARDWARE[v.hardware].mem_capacity
            used = w.mem_used.get(v.hardware, 0.0)
            if used + v.profile.peak_memory > cap:
                continue
            util = w.util.get(v.hardware, 0.0)
            if best is None or util < best[0]:
                best = (util, w.name)
        return best[1] if best else None

    # ------------------------------------------------------------------
    def select_arch(self, arch: str, batch: int,
                    latency_slo: Optional[float]) -> Selection:
        key = ("arch", arch, batch, None if latency_slo is None
               else round(latency_slo, 4))
        sel = self._try_cache(key, batch, latency_slo)
        if sel is not None:
            return sel
        cands = sorted(self.store.registry.variants_of(arch),
                       key=lambda v: v.profile.latency(batch)
                       if batch <= v.profile.max_batch else float("inf"))
        sel = self._pick_running(cands, batch, latency_slo) \
            or self._pick_load(cands, batch, latency_slo)
        self._remember(key, sel)
        return sel

    def select_usecase(self, task: str, dataset: str, accuracy: float,
                       batch: int, latency_slo: Optional[float],
                       user: str = "public") -> Selection:
        key = ("usecase", task, dataset, round(accuracy, 4), batch,
               None if latency_slo is None else round(latency_slo, 4))
        sel = self._try_cache(key, batch, latency_slo)
        if sel is not None:
            return sel
        cands = self.store.registry.top_variants_for_usecase(
            task, dataset, accuracy, n=self.top_n, user=user)
        if not cands:
            return Selection(None, None, False, "reject",
                             reason="no variant meets accuracy")
        sel = self._pick_running(cands, batch, latency_slo) \
            or self._pick_load(cands, batch, latency_slo)
        self._remember(key, sel)
        return sel

    def select_variant(self, variant: str, batch: int) -> Selection:
        """User named the variant explicitly: only pick the worker."""
        v = self.store.variant(variant)
        insts = [i for i in self.store.running_instances_of(v.name)
                 if not self.store.is_overloaded(i)]
        if insts:
            inst = self._least_loaded_worker(insts)
            return Selection(v, inst.worker, False, "running")
        worker = self._worker_for_load(v)
        if worker is None:
            return Selection(None, None, False, "reject", reason="no worker")
        return Selection(v, worker, True, "load")

    # ------------------------------------------------------------------
    def _try_cache(self, key, batch, slo) -> Optional[Selection]:
        name = self._cache.get(key)
        if name is None:
            return None
        v = self.store.registry.variants.get(name)
        if v is None or not _is_valid(v, batch, slo):
            self._cache.pop(key, None)
            return None
        insts = [i for i in self.store.running_instances_of(v.name)
                 if not self.store.is_overloaded(i)]
        if not insts:
            self._cache.pop(key, None)   # stale: fall through to full scan
            return None
        inst = self._least_loaded_worker(insts)
        return Selection(v, inst.worker, False, "cache")

    def _remember(self, key, sel: Selection) -> None:
        if sel.variant is not None and sel.outcome in ("running", "load"):
            self._cache[key] = sel.variant.name

    def invalidate(self, variant: str) -> None:
        for k in [k for k, v in self._cache.items() if v == variant]:
            self._cache.pop(k, None)
