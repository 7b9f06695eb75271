"""Two-level autoscaling (paper §6).

Worker autoscaler (§6.2): per running variant, compare current batch-weighted
load w_curr against the servable max w_max. If the remaining delta cannot
absorb a 5% spike, scale up by (a) replication on CPU, or (b) variant
upgrading (CPU -> accelerator, or accelerator variant optimized for a larger
batch). Scale-down is hysteretic: T consecutive supportable slots (10 CPU /
20 accel) before removing a replica or downgrading; an accel batch-1 variant
downgrades to CPU.

Master autoscaler (§6.1): blacklists workers above 80% utilization or with
latency spikes, starts a new accelerator worker when accelerator models are
contended, a CPU-only worker when only CPU is saturated (threshold 65%), and
retires idle workers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from repro_torch.core.abstraction import Variant
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.worker import Worker
from repro_torch.sim import hardware as HW


# ---------------------------------------------------------------------------
# variant family navigation


def _family(store: MetadataStore, v: Variant) -> List[Variant]:
    """Variants of the same arch+hardware+framework, sorted by batch_opt."""
    out = [w for w in store.registry.variants_of(v.arch)
           if w.hardware == v.hardware and w.framework == v.framework]
    return sorted(out, key=lambda w: w.batch_opt)


def upgrade_candidate(store: MetadataStore, v: Variant) -> Optional[Variant]:
    fam = _family(store, v)
    bigger = [w for w in fam if w.batch_opt > v.batch_opt]
    return bigger[0] if bigger else None


def downgrade_candidate(store: MetadataStore, v: Variant) -> Optional[Variant]:
    fam = _family(store, v)
    smaller = [w for w in fam if w.batch_opt < v.batch_opt]
    return smaller[-1] if smaller else None


def accel_upgrade_for_load(store: MetadataStore, v: Variant,
                           load_qps: float) -> Optional[Variant]:
    """Cheapest accelerator variant of the same arch that can serve the load."""
    cands = [w for w in store.registry.variants_of(v.arch) if w.is_accel]
    cands = [w for w in cands if w.profile.peak_qps >= load_qps]
    cands.sort(key=lambda w: (HW.HARDWARE[w.hardware].cost_rate,
                              w.batch_opt))
    return cands[0] if cands else None


def cpu_downgrade(store: MetadataStore, v: Variant) -> Optional[Variant]:
    cands = [w for w in store.registry.variants_of(v.arch) if not w.is_accel]
    cands.sort(key=lambda w: -w.profile.peak_qps)
    return cands[0] if cands else None


# ---------------------------------------------------------------------------
# worker autoscaler


class WorkerAutoscaler:
    def __init__(self, worker: Worker, store: MetadataStore,
                 request_worker_load: Optional[Callable] = None,
                 allow_upgrade: bool = True):
        """``request_worker_load(variant, origin_worker)`` asks the master to
        place a variant on some worker with the right hardware (paper §6.2:
        a CPU-only worker coordinates with the master for a GPU upgrade).
        ``allow_upgrade=False`` reproduces the INDV baseline (replication
        only, no variant upgrading — paper §8.1)."""
        self.w = worker
        self.store = store
        self.request_worker_load = request_worker_load
        self.allow_upgrade = allow_upgrade
        self._down_counts: Dict[str, int] = {}
        self._idle_counts: Dict[str, int] = {}
        self.idle_unload_ticks = 45   # unload variants idle for this long
        worker.loop.every(worker.cfg.autoscale_period, self.tick,
                          stop=lambda: not worker.alive)

    # -- helpers -----------------------------------------------------------
    def _w_max(self, v: Variant, replicas: int) -> float:
        if v.is_accel:
            return v.profile.peak_qps
        return replicas * v.profile.peak_qps

    def _cpu_slots_free(self) -> int:
        dev = self.w.devices.get("cpu-host")
        if dev is None:
            return 0
        used = sum(li.replicas for li in self.w.instances.values()
                   if not li.variant.is_accel)
        return max(0, dev.slots - used)

    # -- the decision loop ---------------------------------------------------
    def tick(self) -> None:
        if not self.w.alive:
            return
        cfg = self.w.cfg
        for vname, li in list(self.w.instances.items()):
            st = self.store.instance(vname, self.w.name)
            if st is None or not li.running:
                continue
            v = li.variant
            w_curr = st.qps
            w_max = self._w_max(v, li.replicas)
            backlog = len(li.pending)
            # idle-unload: INFaaS does not persist idling models (paper §1)
            if w_curr < 1e-9 and not backlog and li.outstanding == 0:
                ic = self._idle_counts.get(vname, 0) + 1
                self._idle_counts[vname] = ic
                if ic >= self.idle_unload_ticks:
                    self.w.unload_variant(vname)
                    self._idle_counts.pop(vname, None)
                    continue
            else:
                self._idle_counts[vname] = 0
            if (w_max - w_curr) <= cfg.headroom * w_max or backlog > \
                    2 * v.profile.max_batch:
                self._scale_up(li, v, w_curr)
                self._down_counts[vname] = 0
            elif self._can_scale_down(li, v, w_curr):
                c = self._down_counts.get(vname, 0) + 1
                self._down_counts[vname] = c
                t_lim = cfg.t_down_accel if v.is_accel else cfg.t_down_cpu
                if c >= t_lim:
                    self._scale_down(li, v)
                    self._down_counts[vname] = 0
            else:
                self._down_counts[vname] = 0

    # -- scale up -------------------------------------------------------------
    def _scale_up(self, li, v: Variant, w_curr: float) -> None:
        target = w_curr * (1.0 + 2 * self.w.cfg.headroom) + 1e-9
        if not v.is_accel:
            needed = max(li.replicas + 1,
                         int(math.ceil(target / v.profile.peak_qps)))
            can_replicate = (needed - li.replicas) <= self._cpu_slots_free()
            upgrade = accel_upgrade_for_load(self.store, v, target) \
                if self.allow_upgrade else None
            # paper: compare loading latency + cost; pick cheaper feasible
            if can_replicate and (upgrade is None or self._replicate_cheaper(
                    v, needed, upgrade)):
                self.w.set_replicas(v.name, needed)
                return
            if upgrade is not None:
                self._upgrade_to(li, v, upgrade)
                return
            if can_replicate:
                self.w.set_replicas(v.name, needed)
            elif self.request_worker_load is not None:
                # no local headroom: replicate horizontally (INDV path)
                self.request_worker_load(v, self.w.name)
        else:
            up = upgrade_candidate(self.store, v) if self.allow_upgrade \
                else None
            if up is not None:
                self._upgrade_to(li, v, up)
            elif self.request_worker_load is not None:
                # already at max batch on this device: scale out
                self.request_worker_load(v, self.w.name)

    def _replicate_cheaper(self, v: Variant, replicas: int,
                           upgrade: Variant) -> bool:
        cfg = self.w.cfg
        cpu = HW.HARDWARE["cpu-host"]
        rep_cost = (replicas * cfg.cores_per_replica / cfg.cpu_cores) \
            * cpu.cost_rate
        up_cost = HW.HARDWARE[upgrade.hardware].cost_rate
        return rep_cost <= up_cost

    def _upgrade_to(self, li, old: Variant, new: Variant) -> None:
        if new.hardware in self.w.hardware:
            dev = self.w.devices[new.hardware]
            fits = dev.mem_used + new.profile.peak_memory <= \
                dev.hw.mem_capacity
            if fits:
                def switch():
                    # move backlog to the upgraded variant, retire the old
                    old_li = self.w.instances.get(old.name)
                    new_li = self.w.instances.get(new.name)
                    if old_li is None or new_li is None:
                        return
                    while old_li.pending:
                        new_li.pending.append(old_li.pending.popleft())
                    if old_li.outstanding == 0:
                        self.w.unload_variant(old.name)
                    self.w._try_dispatch(new.name)
                self.w.load_variant(new, on_ready=switch)
                return
        if self.request_worker_load is not None:
            self.request_worker_load(new, self.w.name)

    # -- scale down -----------------------------------------------------------
    def _can_scale_down(self, li, v: Variant, w_curr: float) -> bool:
        margin = 1.0 - self.w.cfg.headroom
        if not v.is_accel:
            if li.replicas <= 1:
                return False
            return w_curr <= margin * (li.replicas - 1) * v.profile.peak_qps
        down = downgrade_candidate(self.store, v)
        if down is not None:
            return w_curr <= margin * down.profile.peak_qps
        cpu = cpu_downgrade(self.store, v)
        if cpu is not None:
            return w_curr <= margin * cpu.profile.peak_qps
        return w_curr <= 0.05 * v.profile.peak_qps

    def _scale_down(self, li, v: Variant) -> None:
        if not v.is_accel:
            self.w.set_replicas(v.name, li.replicas - 1)
            return
        down = downgrade_candidate(self.store, v)
        if down is None:
            # batch-1 accelerator variant -> downgrade to CPU (paper §6.2)
            cpu = cpu_downgrade(self.store, v)
            if cpu is not None:
                self._upgrade_to(li, v, cpu)
            return
        self._upgrade_to(li, v, down)


# ---------------------------------------------------------------------------
# master autoscaler


@dataclasses.dataclass
class MasterScaleConfig:
    period: float = 2.0
    util_blacklist: float = 0.80
    util_unblacklist: float = 0.60
    util_scaleup: float = 0.65
    util_idle: float = 0.05
    min_workers: int = 1
    max_workers: int = 64
    latency_spike_factor: float = 2.0
    retire_grace: float = 90.0   # never retire a worker younger than this


class MasterAutoscaler:
    def __init__(self, store: MetadataStore, loop,
                 start_worker: Callable[[str], None],
                 stop_worker: Callable[[str], None],
                 cfg: MasterScaleConfig = MasterScaleConfig()):
        self.store = store
        self.loop = loop
        self.start_worker = start_worker
        self.stop_worker = stop_worker
        self.cfg = cfg
        self.pending_starts = 0
        self._started: Dict[str, float] = {}
        loop.every(cfg.period, self.tick)

    def n_workers(self) -> int:
        return sum(1 for w in self.store.workers.values() if w.alive) + \
            self.pending_starts

    def tick(self) -> None:
        now = self.loop.now()
        live = self.store.live_workers(now)
        if not live:
            return
        # ---- blacklist / un-blacklist (transient overload diversion).
        # Never blacklist the last non-blacklisted accelerator worker:
        # diverting requires somewhere to divert TO.
        accel_contended = False
        open_accel = [w for w in live if w.has_accel() and not w.blacklisted]
        for w in live:
            peak = max(w.util.values()) if w.util else 0.0
            spike = self._latency_spike(w.name)
            if peak > self.cfg.util_blacklist or spike:
                if w.has_accel() and len(open_accel) <= 1 \
                        and w in open_accel:
                    pass   # lone accel worker stays routable
                else:
                    w.blacklisted = True
                    if w in open_accel:
                        open_accel.remove(w)
                if spike and w.has_accel():
                    accel_contended = True
            elif w.blacklisted and peak < self.cfg.util_unblacklist:
                w.blacklisted = False
                if w.has_accel():
                    open_accel.append(w)
        # ---- scale out
        accel_workers = [w for w in live if w.has_accel()]
        accel_utils = [w.util.get(h, 0.0) for w in accel_workers
                       for h in w.hardware if h != "cpu-host"]
        cpu_utils = [w.util.get("cpu-host", 0.0) for w in live
                     if "cpu-host" in w.hardware]
        if self.n_workers() < self.cfg.max_workers:
            all_accel_hot = bool(accel_utils) and min(accel_utils) > \
                self.cfg.util_scaleup
            if accel_contended and all_accel_hot or (
                    accel_utils and all_accel_hot):
                self._start("accel")
            elif cpu_utils and (sum(cpu_utils) / len(cpu_utils)
                                > self.cfg.util_scaleup) \
                    and not accel_contended:
                self._start("cpu")
        # ---- retire idle workers (with a grace period so fresh capacity
        # is not dismantled before the load arrives)
        if len(live) > self.cfg.min_workers:
            for w in live:
                if now - self._started.setdefault(w.name, now) < \
                        self.cfg.retire_grace:
                    continue
                peak = max(w.util.values()) if w.util else 0.0
                has_instances = bool(self.store.worker_instances(w.name))
                if peak < self.cfg.util_idle and not has_instances:
                    self.stop_worker(w.name)
                    break   # at most one per tick (paper: not reckless)

    def _latency_spike(self, worker: str) -> bool:
        for inst in self.store.worker_instances(worker):
            v = self.store.variant(inst.variant)
            expected = v.profile.latency(v.batch_opt)
            if inst.avg_latency > self.cfg.latency_spike_factor * expected \
                    and inst.avg_latency > 0:
                return True
        return False

    def _start(self, kind: str) -> None:
        self.pending_starts += 1

        def started():
            self.pending_starts -= 1
        self.start_worker(kind, started)
