"""Architecture configuration (the port's own copy of ``repro.configs.base``).

The fields, defaults and ``reduced()`` of every family come across: dense,
moe (routed experts), hybrid (Mamba2 + shared attention), ssm (xLSTM),
audio (enc-dec) and vlm (cross-attention). The kernel-dispatch names are
the port's:

* ``attention_impl``: ``"torch"`` (plain PyTorch), ``"torch_chunked"``
  (plain PyTorch, with long full-sequence attention taken block by block
  and a recomputing backward: the counterpart of ``"xla_chunked"``) or
  ``"cuda"`` (the hand-written flash-prefill and decode-attention
  kernels, which have no backward);
* ``quantize``: ``"none"``, ``"int8"`` (plain dequant matmul) or
  ``"int8_cuda"`` (the int8 GEMM kernel).

``for_device`` selects the kernel impls for a CUDA device; nothing on the
main path asks for the plain impls on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
ATTENTION_IMPLS = ("torch", "torch_chunked", "cuda")
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
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0               # Mamba2 state size N
    ssm_chunk: int = 256             # SSD chunk length
    shared_attn_every: int = 6       # zamba2: shared attention block period
    # --- xLSTM ---
    slstm_every: int = 4             # one sLSTM block per this many layers
    # --- audio (enc-dec) ---
    n_encoder_layers: int = 0
    # --- vlm ---
    cross_attn_every: int = 0        # 0 = no cross attention
    n_image_tokens: int = 0          # stub patch-embedding count
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    attention_impl: str = "torch"
    quantize: str = "none"
    remat: bool = True               # recompute each block in backward
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
        head); for the moe family every expert.

        The count is that of the initialised tree, which the launcher turns
        into weight bytes. ``repro``'s formula differs for four families:
        it counts the audio decoder's cross blocks without their MLPs and
        adds the vlm cross layers' attention once more; for the hybrid
        family it sizes ``w_dt`` by the attention heads where the layer has
        ``d_inner // head_dim_mamba`` Mamba heads and leaves out the
        convolutions, ``A_log``, ``D`` and ``dt_bias``; for the ssm family
        it takes 8 d^2 a mLSTM block and 5 d^2 a sLSTM block, where the
        tree holds 6 d^2 + 2 H d + 2 H (``w_up``, ``wq``, ``wk``, ``wv``,
        ``w_down``, ``w_gate`` and ``gate_bias``) and 4 d^2 + 4 H hd^2 +
        4 d + 3 d f (``w_in``, ``r``, ``bias`` and the gated FFN of width
        f = max(128, (4 d / 3) // 64 * 64)). The dense and moe counts are
        ``repro``'s.
        """
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token: for the moe family the ``top_k``
        routed and the shared experts only (``repro``'s ``active_only``
        rule), every parameter for the others."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        d, hd = self.d_model, self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        block = attn + 3 * d * self.d_ff
        emb = 2 * self.vocab * d
        if self.family == "moe":
            n_e = self.top_k if active_only else self.n_experts
            n_e += self.n_shared_experts
            return emb + self.n_layers * (attn + n_e * 3 * d * self.d_ff
                                          + d * self.n_experts)
        if self.family == "ssm":
            # models.xlstm: n_s sLSTM blocks, the rest mLSTM
            H = self.n_heads
            n_s = self.n_layers // self.slstm_every
            f = max(128, int(d * 4 / 3) // 64 * 64)
            m_blk = 6 * d * d + 2 * H * d + 2 * H
            s_blk = 4 * d * d + 4 * H * hd * hd + 4 * d + 3 * d * f
            return emb + (self.n_layers - n_s) * m_blk + n_s * s_blk
        if self.family == "hybrid":
            # Mamba2 layer (models.ssm.mamba_dims): w_z, w_x, w_bc, w_dt,
            # out_proj, the two depthwise convs with their biases, A_log,
            # D and dt_bias; one shared block, counted once
            di = 2 * d
            h = di // (64 if d >= 512 else 16)
            n2 = 2 * self.ssm_state
            mamba = (d * (2 * di + n2 + h) + di * d + 5 * (di + n2)
                     + 3 * h)
            return emb + self.n_layers * mamba + block
        n_blocks = self.n_layers   # vlm: self and cross layers together
        if self.family == "audio":
            n_blocks = self.n_encoder_layers + 2 * self.n_layers
        return emb + n_blocks * block

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
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            cross_attn_every=(min(self.cross_attn_every, 2)
                              if self.cross_attn_every else 0),
            n_image_tokens=(min(self.n_image_tokens, 16)
                            if self.n_image_tokens else 0),
            dtype="float32",
            param_dtype="float32",
            remat=False,
        )

    def for_device(self, device, speculate: bool = False) -> "ArchConfig":
        """The config with the kernel impls selected on a CUDA device.

        On the CPU the config is returned unchanged: the kernels run only on
        the card. ``speculate=True`` builds a speculating *target*: its
        attention stays plain PyTorch, the counterpart of the reference's
        XLA path, because the verify window runs outside the fused decode
        kernel and plain decode must give the window's bits (the engine
        refuses ``attention_impl="cuda"`` with a draft); its int8
        projections still take the int8 GEMM. A draft is built without it.
        """
        if str(device).split(":")[0] != "cuda":
            return self
        quantize = "int8_cuda" if self.quantize == "int8" else self.quantize
        return dataclasses.replace(
            self, attention_impl="torch" if speculate else "cuda",
            quantize=quantize)
