"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks. [arXiv:2411.15242; hf]

38 Mamba2 (SSD) layers; one *shared* transformer block (attention + SwiGLU,
same parameters each invocation) applied every ``shared_attn_every`` layers,
as in the Zamba2 design.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    head_dim=64,
    ssm_state=64,
    ssm_chunk=256,
    shared_attn_every=6,
    subquadratic=True,
    source="arXiv:2411.15242",
)
