"""The profiled span of a ``--trace 1`` run: ``torch.profiler`` over a
few seconds near the window's end, reduced to device intervals by kernel class,
the device's busy time (the union of its intervals), and the longest idle
gaps named by what the host was doing in them.

The kernel classes are a frozen copy of the port's kernel names (the five
hand-written CUDA kernels) and of cuBLAS's GEMM names on the H100.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Tuple

CLASSES = (
    ("flash_attention", re.compile(r"flash_fwd_")),
    ("fused_paged_decode", re.compile(r"fused_decode_")),
    ("paged_decode", re.compile(r"paged_decode_")),
    ("decode_attention", re.compile(r"(?<![A-Za-z_])decode_(mma_)?kernel<")),
    ("int8_matmul", re.compile(r"int8_gemv|int8_mma")),
    ("gemm", re.compile(r"nvjet|gemm|cutlass|xmma|sm90_", re.I)),
    ("copy", re.compile(r"memcpy|memset|copy", re.I)),
    ("reduce", re.compile(r"reduce|softmax|norm", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


class Span:
    """One profiled span: start it, stop it, then read its intervals."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.t_prof = self.t_start = self.t_stop = 0.0
        self.marks: Dict[str, dict] = {}
        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []

    @property
    def started(self) -> bool:
        return self.t_start > 0.0

    @property
    def stopped(self) -> bool:
        return self.t_stop > 0.0

    def start(self, mark: Optional[dict] = None) -> None:
        self.t_prof = time.monotonic()       # the trace's time 0
        self._prof.start()
        self.t_start = time.monotonic()
        self.marks["start"] = mark or {}

    def stop(self, mark: Optional[dict] = None) -> None:
        self.t_stop = time.monotonic()
        self.marks["stop"] = mark or {}
        self._prof.stop()

    def read(self) -> None:
        """Device and host intervals, in seconds on the run's monotonic
        clock (the profiler's events count from its start)."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.events():
            a = self.t_prof + e.time_range.start * 1e-6
            b = self.t_prof + e.time_range.end * 1e-6
            (self.kernels if e.device_type == cuda else self.host).append(
                (e.name, a, b))
        self.kernels.sort(key=lambda k: k[1])

    def _inside(self):
        """The device intervals clipped to the span, empty ones left out."""
        for name, a, b in self.kernels:
            a, b = max(a, self.t_start), min(b, self.t_stop)
            if b > a:
                yield name, a, b

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def busy_s(self) -> float:
        """The union of the device's intervals inside the span."""
        busy, end = 0.0, self.t_start
        for _, a, b in self._inside():
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
        return busy

    def class_s(self, cls: str) -> float:
        """Device seconds of one kernel class inside the span."""
        return sum(b - a for n, a, b in self._inside()
                   if kernel_class(n) == cls)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self._inside():
            key = kernel_class(name)
            if key == "other":
                key = name[:60]
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps with no device interval, each named by the
        shortest host event that covers its middle."""
        gaps, end = [], self.t_start
        for _, a, b in self._inside():
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t_stop > end:
            gaps.append((end, self.t_stop))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            cover = [(hb - ha, name) for name, ha, hb in self.host
                     if ha <= mid <= hb]
            out.append([min(cover)[1] if cover else "no host event", b - a])
        return out
