"""Model repository (paper §4): persistent store for model-variant binaries.

A "binary" is either (a) a byte-size record for simulated variants (load
latency derives from bytes / load bandwidth), or (b) an actual parameter
tree held in memory for real execution. The on-disk store (``root``) goes
through the distributed checkpoint module, which is not ported yet, so a
``root`` raises."""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.sim import hardware as HW


class ModelRepository:
    def __init__(self, root: Optional[str] = None):
        self._sizes: Dict[str, float] = {}
        self._blobs: Dict[str, Any] = {}
        if root:
            raise NotImplementedError(
                "not ported yet: an on-disk model repository (root=) needs "
                "the distributed checkpoint module")

    # -- simulated binaries -------------------------------------------------
    def put_size(self, name: str, num_bytes: float) -> None:
        self._sizes[name] = float(num_bytes)

    def size(self, name: str) -> float:
        return self._sizes.get(name, 0.0)

    def load_latency(self, name: str, hardware: str) -> float:
        hw = HW.HARDWARE[hardware]
        base = 0.5 if hw.kind == "cpu" else 1.0
        return base + self.size(name) / hw.load_bw

    # -- real parameter pytrees ----------------------------------------------
    def put_params(self, name: str, params: Any) -> None:
        self._blobs[name] = params

    def get_params(self, name: str) -> Any:
        if name in self._blobs:
            return self._blobs[name]
        raise KeyError(name)

    def get_params_quantized(self, name: str, mode: str = "int8") -> Any:
        """Quantize-at-load: the repository stores one fp parameter tree
        per model and derives quantized variants on demand, instead of
        persisting a separate binary per dtype (paper §4's variant
        binaries, collapsed for weight-only quantization). The derived
        tree is cached in-memory under ``name#mode`` so repeated loads of
        the same quantized variant share one quantization pass."""
        if mode == "none":
            return self.get_params(name)
        if mode != "int8":
            raise ValueError(f"unknown quantize mode {mode!r}")
        key = f"{name}#{mode}"
        if key not in self._blobs:
            from repro_torch.models.quantize import quantize_params_dense
            self._blobs[key] = quantize_params_dense(self.get_params(name))
        return self._blobs[key]

    def has(self, name: str) -> bool:
        return name in self._blobs or name in self._sizes
