"""Cluster assembly helpers: wire up loop + metadata store + repository +
master + workers and register the assigned architecture zoo."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.api import INFaaS
from repro_torch.core.master import Master, MasterConfig
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.repository import ModelRepository
from repro_torch.sim.clock import Clock, EventLoop, RealClock


def serving_archs() -> List[ArchConfig]:
    """Archs with at least one variant on standard worker hardware
    (cpu-host / h100-1); the giants that only fit several cards stay out."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import profiler as prof
    out = []
    for cfg in ARCHS.values():
        vs = prof.generate_variants(cfg)
        if any(v.hardware in ("cpu-host", "h100-1") for v in vs):
            out.append(cfg)
    return out


@dataclasses.dataclass
class Cluster:
    loop: Clock
    store: MetadataStore
    repo: ModelRepository
    master: Master
    api: INFaaS
    # real-backend executors created so far (one per worker): the wall-
    # clock runtime walks these to stop stepper threads at shutdown
    executors: List = dataclasses.field(default_factory=list)

    def run_until(self, t: float) -> None:
        self.loop.run_until(t)


def make_cluster(n_accel: int = 1, n_cpu: int = 0,
                 archs: Optional[Sequence[ArchConfig]] = None,
                 autoscale: bool = True,
                 cfg: Optional[MasterConfig] = None,
                 backend: str = "sim",
                 engine_cfg=None,
                 clock: str = "virtual",
                 device="cuda", reduced: bool = False) -> Cluster:
    """Assemble a cluster.

    ``backend="sim"`` (default): workers answer from profiled t(b) models —
    any scale, no model execution.

    ``backend="real"``: every worker gets an
    ``repro_torch.serving.executor.EngineExecutor`` on ``device`` (default
    CUDA; raises without it) — jobs run for real on continuous-batching
    engines, measured service times drive the virtual clock, and variant
    profiles are re-fit from the measurements as they accumulate. The archs
    serve at full width unless ``reduced`` asks for their ``reduced()``
    configs (the CPU tests pass ``device="cpu", reduced=True``). Pass a
    small ``archs`` list (each arch builds real model params) and
    optionally an ``EngineExecutorConfig`` as ``engine_cfg``.

    ``clock="wall"`` (requires ``backend="real"``): the control plane runs
    against ``RealClock`` — callbacks fire on a scheduler thread as wall
    time passes — and every worker gets a ``ThreadedEngineExecutor``
    stepped by its own background thread, with token streaming enabled.
    Wrap the result in ``repro_torch.serving.runtime.ServingRuntime`` for
    thread-safe submission and drain-on-shutdown.
    """
    if backend not in ("sim", "real"):
        raise ValueError(f"unknown backend {backend!r} (sim|real)")
    if clock not in ("virtual", "wall"):
        raise ValueError(f"unknown clock {clock!r} (virtual|wall)")
    if clock == "wall" and backend != "real":
        raise ValueError("clock='wall' requires backend='real': the sim "
                         "executor has no work to do in real time")
    store = MetadataStore()
    repo = ModelRepository()
    use_archs = list(archs if archs is not None else serving_archs())
    executor_factory = None
    executors: List = []
    if backend == "real":
        from repro_torch import resolve_device
        from repro_torch.serving.executor import (EngineExecutor,
                                                  EngineExecutorConfig)
        dev = resolve_device(device)
        arch_cfgs = {a.name: a.reduced() if reduced else a
                     for a in use_archs}
        ecfg = engine_cfg or EngineExecutorConfig()
        model_cache: dict = {}   # share built params across workers

        cls = EngineExecutor
        if clock == "wall":
            from repro_torch.serving.runtime import ThreadedEngineExecutor
            cls = ThreadedEngineExecutor
            ecfg = dataclasses.replace(ecfg, stream=True)

        def executor_factory():
            ex = cls(arch_cfgs, ecfg, model_cache=model_cache, device=dev)
            executors.append(ex)
            return ex
    # the wall clock's scheduler thread starts only once the device is
    # known to exist
    loop: Clock = RealClock() if clock == "wall" else EventLoop()
    master = Master(store, repo, loop, cfg or MasterConfig(),
                    autoscale=autoscale, executor_factory=executor_factory)
    api = INFaaS(master)
    for cfgA in use_archs:
        master.register_model(cfgA)
    for _ in range(n_accel):
        master.add_worker("accel")
    for _ in range(n_cpu):
        master.add_worker("cpu")
    return Cluster(loop, store, repo, master, api, executors=executors)
