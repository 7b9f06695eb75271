"""Metadata store (paper §4, §7): the decision-making medium shared by the
master and workers.

Implemented as an in-process key-value store with typed views, mirroring the
paper's Redis deployment (read-mostly; one-time updates applied immediately;
utilization refreshed every ~2 s by worker monitoring daemons). Snapshots
capture the static registry; dynamic state is rebuilt from worker heartbeats
after a restore (paper §7 failure handling).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.core.abstraction import Registry, Variant


@dataclasses.dataclass
class InstanceState:
    """One model-variant running on one worker."""
    variant: str
    worker: str
    replicas: int = 1
    qps: float = 0.0               # batch-weighted request rate (EWMA)
    avg_latency: float = 0.0       # seconds (EWMA)
    running: bool = True
    loading: bool = False
    last_used: float = 0.0


@dataclasses.dataclass
class WorkerState:
    name: str
    hardware: Tuple[str, ...]          # e.g. ("cpu-host", "h100-1")
    heartbeat: float = 0.0
    util: Dict[str, float] = dataclasses.field(default_factory=dict)
    blacklisted: bool = False
    alive: bool = True
    mem_used: Dict[str, float] = dataclasses.field(default_factory=dict)

    def has_accel(self) -> bool:
        return any(h != "cpu-host" for h in self.hardware)


class MetadataStore:
    def __init__(self):
        self.registry = Registry()
        self.workers: Dict[str, WorkerState] = {}
        # (variant, worker) -> InstanceState
        self.instances: Dict[Tuple[str, str], InstanceState] = {}
        self._snapshot_blob: Optional[str] = None

    # ------------------------------------------------------------------
    # static registry passthrough
    def variant(self, name: str) -> Variant:
        return self.registry.variants[name]

    # ------------------------------------------------------------------
    # dynamic state: workers
    def upsert_worker(self, name: str, hardware: Tuple[str, ...],
                      now: float) -> WorkerState:
        w = self.workers.get(name)
        if w is None:
            w = WorkerState(name=name, hardware=tuple(hardware),
                            heartbeat=now)
            self.workers[name] = w
        return w

    def heartbeat(self, worker: str, util: Dict[str, float],
                  mem_used: Dict[str, float], now: float) -> None:
        w = self.workers[worker]
        w.heartbeat = now
        w.util = dict(util)
        w.mem_used = dict(mem_used)

    def live_workers(self, now: float, timeout: float = 6.0) -> List[WorkerState]:
        return [w for w in self.workers.values()
                if w.alive and now - w.heartbeat <= timeout]

    def mark_dead(self, worker: str) -> None:
        w = self.workers.get(worker)
        if w is not None:
            w.alive = False
        for key, inst in list(self.instances.items()):
            if inst.worker == worker:
                del self.instances[key]

    # ------------------------------------------------------------------
    # dynamic state: instances
    def instance(self, variant: str, worker: str) -> Optional[InstanceState]:
        return self.instances.get((variant, worker))

    def set_instance(self, inst: InstanceState) -> None:
        self.instances[(inst.variant, inst.worker)] = inst

    def drop_instance(self, variant: str, worker: str) -> None:
        self.instances.pop((variant, worker), None)

    def instances_of(self, variant: str) -> List[InstanceState]:
        return [i for (v, _), i in self.instances.items() if v == variant]

    def running_instances_of(self, variant: str) -> List[InstanceState]:
        out = []
        for inst in self.instances_of(variant):
            w = self.workers.get(inst.worker)
            if inst.running and not inst.loading and w and w.alive \
                    and not w.blacklisted:
                out.append(inst)
        return out

    def is_running(self, variant: str) -> bool:
        return bool(self.running_instances_of(variant))

    def worker_instances(self, worker: str) -> List[InstanceState]:
        return [i for (_, w), i in self.instances.items() if w == worker]

    # ------------------------------------------------------------------
    # overload predicate (paper §5: QPS and latency exceed profiled values)
    def is_overloaded(self, inst: InstanceState) -> bool:
        v = self.variant(inst.variant)
        qps_cap = v.profile.peak_qps * inst.replicas
        return (inst.qps >= 0.95 * qps_cap
                or inst.avg_latency > 1.5 * v.profile.latency(v.batch_opt))

    # ------------------------------------------------------------------
    # snapshot / recovery (paper §7)
    def snapshot(self) -> str:
        blob = {
            "archs": {n: {**dataclasses.asdict(a)}
                      for n, a in self.registry.archs.items()},
            "variants": {n: dataclasses.asdict(v)
                         for n, v in self.registry.variants.items()},
        }
        self._snapshot_blob = json.dumps(blob)
        return self._snapshot_blob

    @classmethod
    def restore(cls, blob: str) -> "MetadataStore":
        from repro_torch.core.abstraction import (ModelArchInfo, Variant,
                                            VariantProfile)
        data = json.loads(blob)
        store = cls()
        for n, a in data["archs"].items():
            a = dict(a)
            a["allowed_users"] = tuple(a.get("allowed_users", ()))
            store.registry.add_arch(ModelArchInfo(**a))
        for n, v in data["variants"].items():
            v = dict(v)
            v["profile"] = VariantProfile(**v["profile"])
            store.registry.variants[n] = Variant(**v)
        # dynamic state (workers, instances) is rebuilt from heartbeats
        return store
