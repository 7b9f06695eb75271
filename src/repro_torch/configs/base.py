"""Architecture configuration (the port's own copy of ``repro.configs.base``).

Only the fields, defaults, ``reduced()`` and ``param_count`` of the dense
family come across in this slice. The kernel-dispatch names are the port's:

* ``attention_impl``: ``"torch"`` (plain PyTorch) or ``"cuda"`` (the
  hand-written flash-prefill and fused paged-decode kernels);
* ``quantize``: ``"none"``, ``"int8"`` (plain dequant matmul) or
  ``"int8_cuda"`` (the int8 GEMM kernel).

``for_device`` selects the kernel impls for a CUDA device; nothing on the
main path asks for the plain impls on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
ATTENTION_IMPLS = ("torch", "cuda")
QUANTIZE_MODES = ("none", "int8", "int8_cuda")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static architecture description."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    rope_theta: float = 500_000.0
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    attention_impl: str = "torch"
    quantize: str = "none"
    subquadratic: bool = False
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {self.quantize!r}")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytic parameter count (dense family: untied embed + head)."""
        if self.family != "dense":
            raise NotImplementedError(
                f"param_count for family {self.family!r} is not ported")
        d, hd = self.d_model, self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        return 2 * self.vocab * d + self.n_layers * (attn + 3 * d * self.d_ff)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (``repro``'s ``reduced``)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 8),
            d_model=64,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=16,
            d_ff=128,
            vocab=256,
            dtype="float32",
            param_dtype="float32",
        )

    def for_device(self, device) -> "ArchConfig":
        """The config with the kernel impls selected on a CUDA device.

        On the CPU the config is returned unchanged: the kernels run only on
        the card.
        """
        if str(device).split(":")[0] != "cuda":
            return self
        quantize = "int8_cuda" if self.quantize == "int8" else self.quantize
        return dataclasses.replace(self, attention_impl="cuda",
                                   quantize=quantize)
