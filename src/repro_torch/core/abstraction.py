"""The model-less abstraction (paper §3.2, Fig. 7).

Three-level registry: (task, dataset) -> model architecture -> model-variant.
A variant binds an architecture to one hardware platform, an optimization
batch size, and a numeric format; variants of the same architecture share
accuracy, and differ in latency/memory/cost.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(eq=False)
class VariantProfile:
    """Profiling output (paper §4, Fig. 8): linear latency model
    t(b) = m*b + c, load latency, and peak memory.

    Mutable on purpose: the initial fit is analytic (roofline), and real
    execution (``repro_torch.serving.executor.EngineExecutor``) re-fits m
    and c in place as measured service times accumulate, so every holder of the
    variant — selector, autoscaler, workers — sees the calibrated model.
    ``source`` records which fit is current ("analytic" | "measured").
    ``eq=False`` keeps identity semantics (and hashability, which the
    frozen ``Variant`` holding it relies on) for this shared mutable
    object."""
    m: float                  # seconds per additional batch element
    c: float                  # seconds, intercept
    load_latency: float       # seconds to load onto the target hardware
    peak_memory: float        # bytes (weights + max activation buffers)
    max_batch: int
    peak_qps: float           # saturation throughput (queries/s, batch-weighted)
    source: str = "analytic"  # "analytic" roofline fit | "measured" refit

    def latency(self, batch: int) -> float:
        return self.m * batch + self.c


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    arch: str
    hardware: str             # key into sim.hardware.HARDWARE
    framework: str            # "torch-bf16" | "torch-int8" | "torch-f32"
    batch_opt: int            # batch size this variant was compiled for
    profile: VariantProfile
    accuracy: float

    @property
    def is_accel(self) -> bool:
        return self.hardware != "cpu-host"


@dataclasses.dataclass
class ModelArchInfo:
    name: str
    task: str
    dataset: str
    accuracy: float
    submitter: str = "public"
    is_private: bool = False
    allowed_users: Tuple[str, ...] = ()
    variants: List[str] = dataclasses.field(default_factory=list)

    def accessible_by(self, user: str) -> bool:
        if not self.is_private:
            return True
        return user == self.submitter or user in self.allowed_users


class Registry:
    """Static model metadata, stored inside the metadata store."""

    def __init__(self):
        self.archs: Dict[str, ModelArchInfo] = {}
        self.variants: Dict[str, Variant] = {}

    # -- registration -----------------------------------------------------
    def add_arch(self, info: ModelArchInfo) -> None:
        self.archs[info.name] = info

    def add_variant(self, v: Variant) -> None:
        self.variants[v.name] = v
        arch = self.archs[v.arch]
        if v.name not in arch.variants:
            arch.variants.append(v.name)

    # -- the three lookup granularities ------------------------------------
    def variants_of(self, arch: str) -> List[Variant]:
        return [self.variants[n] for n in self.archs[arch].variants]

    def archs_for_usecase(self, task: str, dataset: str,
                          min_accuracy: float = 0.0,
                          user: str = "public") -> List[ModelArchInfo]:
        return [a for a in self.archs.values()
                if a.task == task and a.dataset == dataset
                and a.accuracy >= min_accuracy and a.accessible_by(user)]

    def top_variants_for_usecase(self, task: str, dataset: str,
                                 min_accuracy: float, n: int = 7,
                                 user: str = "public") -> List[Variant]:
        """Top-N variants meeting the accuracy bar (paper §5: N defaults to
        7 = avg variants/arch). Ranked by batch-1 latency, but diversified:
        the best variant per (hardware, framework) group comes first, so the
        candidate set spans hardware platforms as the paper intends.

        The bar applies per *variant*, not just per arch: quantized
        variants carry a dtype accuracy discount below their parent
        arch's score, so an int8 sibling may be filtered out of a
        use-case that its f32/bf16 siblings still qualify for."""
        cands: List[Variant] = []
        for a in self.archs_for_usecase(task, dataset, min_accuracy, user):
            cands.extend(v for v in self.variants_of(a.name)
                         if v.accuracy >= min_accuracy)
        cands.sort(key=lambda v: v.profile.latency(1))
        seen_groups = set()
        diverse: List[Variant] = []
        rest: List[Variant] = []
        for v in cands:
            g = (v.hardware, v.framework)
            if g not in seen_groups:
                seen_groups.add(g)
                diverse.append(v)
            else:
                rest.append(v)
        return (diverse + rest)[:n]
