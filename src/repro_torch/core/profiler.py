"""Model profiler & optimizer (paper §4).

Two profiling paths:

* **Analytic (roofline)** — the first fit of every variant, before any of
  it has run: per-variant latency at batches {1,4,8} is derived from
  the arch's FLOPs/bytes on the target hardware spec, then fit with the
  paper's linear model t(b) = m*b + c (Fig. 8). Load latency = weight bytes /
  load bandwidth (+ engine start), peak memory = weights + buffers.

* **Measured** — times a real step function (``profile_measured``), or
  re-fits a variant from the service times its executor measured
  (``refit_profile``).

The optimizer step mirrors the paper's TensorRT flow: for every registered
architecture it emits batch-{1,4,8,16,32,64} x {bf16, int8} accelerator
variants (int8 via the hand-written int8 GEMM kernel) plus host-CPU
variants, subject to the target's memory capacity.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.abstraction import (ModelArchInfo, Registry, Variant,
                                    VariantProfile)
from repro_torch.sim import hardware as HW

# serializes in-place VariantProfile mutation (see refit_profile)
_refit_lock = threading.Lock()

PROFILE_BATCHES = (1, 4, 8)
OPT_BATCHES = (1, 4, 8, 16, 32, 64)
PROFILE_CTX = 512      # context length assumed for serve-step profiling

# task/dataset/accuracy registry for the assigned architectures
ARCH_META: Dict[str, Tuple[str, str, float]] = {
    "llama3.2-1b": ("text-generation", "openwebtext", 0.62),
    "minitron-8b": ("text-generation", "openwebtext", 0.70),
    "yi-9b": ("text-generation", "openwebtext", 0.72),
    "phi3-mini-3.8b": ("text-generation", "openwebtext", 0.69),
    "zamba2-1.2b": ("text-generation", "openwebtext", 0.60),
    "moonshot-v1-16b-a3b": ("text-generation", "openwebtext", 0.74),
    "qwen3-moe-235b-a22b": ("text-generation", "openwebtext", 0.78),
    "whisper-base": ("asr", "librispeech", 0.65),
    "llama-3.2-vision-90b": ("vqa", "vqa-v2", 0.80),
    "xlstm-1.3b": ("text-generation", "openwebtext", 0.58),
}

DTYPE_BYTES = {"bf16": 2.0, "int8": 1.0, "f32": 4.0}
DTYPE_ACC_DELTA = {"bf16": 0.0, "int8": -0.004, "f32": 0.001}


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Analytic per-decode-step cost of an architecture."""
    n_active: int            # active params per token
    n_total: int
    kv_bytes_per_seq: float  # context-cache bytes per sequence at PROFILE_CTX
    d_model: int
    n_layers: int

    def flops(self, batch: int) -> float:
        # GEMMs (2*N_active) + attention/state reads (2 * 2 * ctx * d * L)
        attn = 4.0 * self.n_layers * PROFILE_CTX * self.d_model
        return batch * (2.0 * self.n_active + attn)

    def bytes_moved(self, batch: int, wbytes: float) -> float:
        # weights stream once per step; per-sequence cache scales with batch
        return wbytes + batch * self.kv_bytes_per_seq


def workload_model(cfg: ArchConfig) -> WorkloadModel:
    if cfg.subquadratic:
        # recurrent state instead of a KV cache
        state = cfg.n_layers * cfg.d_model * 4 * 64  # coarse state bytes
        kv = float(state)
    else:
        kv = (2.0 * cfg.n_layers * PROFILE_CTX * cfg.n_kv_heads
              * cfg.head_dim * 2.0)
    return WorkloadModel(
        n_active=cfg.active_param_count(), n_total=cfg.param_count(),
        kv_bytes_per_seq=kv, d_model=cfg.d_model, n_layers=cfg.n_layers)


def fit_linear(batches: Sequence[int],
               latencies: Sequence[float]) -> Tuple[float, float]:
    """Least-squares fit of t = m*b + c (paper Fig. 8)."""
    b = np.asarray(batches, np.float64)
    t = np.asarray(latencies, np.float64)
    A = np.stack([b, np.ones_like(b)], axis=1)
    (m, c), *_ = np.linalg.lstsq(A, t, rcond=None)
    return float(max(m, 1e-9)), float(max(c, 1e-6))


def _dispatch_overhead(hw: HW.HardwareSpec) -> float:
    return 2e-4 if hw.kind == "accel" else 5e-5


def analytic_profile(cfg: ArchConfig, hw: HW.HardwareSpec, dtype: str,
                     batch_opt: int) -> VariantProfile:
    wl = workload_model(cfg)
    wbytes = wl.n_total * DTYPE_BYTES[dtype]
    eff = 0.6 if hw.kind == "accel" else 0.35
    # profile at batches spanning the variant's own operating range
    # (1 .. batch_opt), mirroring how the optimizer profiles each TensorRT
    # engine at the batch it targets; the paper's {1,4,8} extrapolation is
    # poor past the memory->compute roofline crossover (see fig8 bench).
    batches = sorted({1, max(batch_opt // 2, 1), batch_opt})
    pts = []
    for b in batches:
        t = HW.roofline_latency(wl.flops(b), wl.bytes_moved(b, wbytes),
                                hw, eff) + _dispatch_overhead(hw)
        pts.append(t)
    if len(batches) == 1:
        batches = [1, 2]
        pts = pts + [HW.roofline_latency(
            wl.flops(2), wl.bytes_moved(2, wbytes), hw, eff)
            + _dispatch_overhead(hw)]
    m, c = fit_linear(batches, pts)
    lat_max = m * batch_opt + c
    act_bytes = (batch_opt * PROFILE_CTX * cfg.d_model * 4.0
                 + batch_opt * wl.kv_bytes_per_seq)
    load = 0.5 + wbytes / hw.load_bw if hw.kind == "cpu" \
        else 1.0 + wbytes / hw.load_bw
    return VariantProfile(
        m=m, c=c, load_latency=load,
        peak_memory=wbytes + act_bytes,
        max_batch=batch_opt,
        peak_qps=batch_opt / lat_max)


def generate_variants(cfg: ArchConfig,
                      hardware: Sequence[str] = ("cpu-host", "h100-1",
                                                 "h100-4")) -> List[Variant]:
    """The optimizer: emit every feasible (hardware, dtype, batch) variant."""
    task, dataset, acc = ARCH_META.get(
        cfg.name, ("text-generation", "openwebtext", 0.6))
    out: List[Variant] = []
    for hw_name in hardware:
        hw = HW.HARDWARE[hw_name]
        if hw.kind == "cpu":
            combos = [("f32", 4), ("bf16", 8), ("int8", 8)]
        else:
            combos = [("bf16", b) for b in OPT_BATCHES]
            combos += [("int8", b) for b in OPT_BATCHES]
        for dtype, batch_opt in combos:
            prof = analytic_profile(cfg, hw, dtype, batch_opt)
            if prof.peak_memory > hw.mem_capacity:
                continue   # does not fit this platform
            out.append(Variant(
                name=f"{cfg.name}/{hw_name}/{dtype}-b{batch_opt}",
                arch=cfg.name, hardware=hw_name,
                framework=f"torch-{dtype}",
                batch_opt=batch_opt, profile=prof,
                accuracy=acc + DTYPE_ACC_DELTA[dtype]))
    return out


def register_all(registry: Registry, cfgs: Sequence[ArchConfig]) -> int:
    """Register every arch + its generated variants. Returns variant count."""
    n = 0
    for cfg in cfgs:
        task, dataset, acc = ARCH_META.get(
            cfg.name, ("text-generation", "openwebtext", 0.6))
        registry.add_arch(ModelArchInfo(
            name=cfg.name, task=task, dataset=dataset, accuracy=acc))
        for v in generate_variants(cfg):
            registry.add_variant(v)
            n += 1
    return n


# ---------------------------------------------------------------------------
# measured profiling (host execution)


def refit_profile(profile: VariantProfile,
                  observations: Dict[int, Sequence[float]],
                  min_points: int = 2) -> bool:
    """Re-fit a variant's latency model from measured service times.

    ``observations`` maps batch size -> measured wall-clock service times
    (seconds). Once at least ``min_points`` distinct batch sizes have been
    observed, t(b) = m*b + c is re-fit over the per-batch means and the
    profile is updated **in place** (m, c, peak_qps, source="measured"), so
    the selector and both autoscalers immediately plan with calibrated
    numbers. Returns True when a refit happened.

    This closes the loop the ROADMAP flagged: real execution feeding the
    control plane's latency model instead of one-off manual calibration.

    Thread-safe: variants (and their profiles) are shared across every
    executor in a cluster, and under the wall-clock runtime refits arrive
    from concurrent stepper threads — the in-place (m, c, peak_qps,
    source) update is serialized under a module lock so a reader never
    sees a torn fit.
    """
    pts = {b: float(np.mean(ts)) for b, ts in observations.items() if ts}
    if len(pts) < min_points:
        return False
    batches = sorted(pts)
    m, c = fit_linear(batches, [pts[b] for b in batches])
    with _refit_lock:
        profile.m, profile.c = m, c
        profile.peak_qps = \
            profile.max_batch / profile.latency(profile.max_batch)
        profile.source = "measured"
    return True


def profile_measured(step_fn: Callable[[int], None],
                     batches: Sequence[int] = PROFILE_BATCHES,
                     repeats: int = 3) -> Tuple[float, float, List[float]]:
    """Time a real step function at several batch sizes; fit t = m*b + c.

    ``step_fn(batch)`` must block until the step completes (e.g. calls
    ``torch.cuda.synchronize()``). Returns (m, c, raw_latencies).
    """
    lats = []
    for b in batches:
        step_fn(b)  # warmup/compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            step_fn(b)
        lats.append((time.perf_counter() - t0) / repeats)
    m, c = fit_linear(batches, lats)
    return m, c, lats
