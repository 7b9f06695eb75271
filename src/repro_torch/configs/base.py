"""Architecture configuration (the port's own copy of ``repro.configs.base``).

The fields, defaults and ``reduced()`` of the dense, audio (enc-dec) and
vlm (cross-attention) families come across; the MoE, SSM and hybrid fields
join with their model code. The kernel-dispatch names are the port's:

* ``attention_impl``: ``"torch"`` (plain PyTorch) or ``"cuda"`` (the
  hand-written flash-prefill and decode-attention kernels);
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
    # --- audio (enc-dec) ---
    n_encoder_layers: int = 0
    # --- vlm ---
    cross_attn_every: int = 0        # 0 = no cross attention
    n_image_tokens: int = 0          # stub patch-embedding count
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
        """Weights that ``init`` makes, norm scales aside (untied embed and
        head).

        ``repro``'s formula counts the audio decoder's cross blocks without
        their MLPs and adds the vlm cross layers' attention once more; the
        count here is that of the initialised tree, which the launcher
        turns into weight bytes.
        """
        if self.family not in ("dense", "audio", "vlm"):
            raise NotImplementedError(
                f"param_count for family {self.family!r} is not ported")
        d, hd = self.d_model, self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        block = attn + 3 * d * self.d_ff
        n_blocks = self.n_layers   # vlm: self and cross layers together
        if self.family == "audio":
            n_blocks = self.n_encoder_layers + 2 * self.n_layers
        return 2 * self.vocab * d + n_blocks * block

    def active_param_count(self) -> int:
        """Parameters touched per token: every one of them, since no ported
        family routes tokens to experts (``repro``'s MoE count joins with
        the MoE family)."""
        return self.param_count()

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
            n_encoder_layers=min(self.n_encoder_layers, 2),
            cross_attn_every=(min(self.cross_attn_every, 2)
                              if self.cross_attn_every else 0),
            n_image_tokens=(min(self.n_image_tokens, 16)
                            if self.n_image_tokens else 0),
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
