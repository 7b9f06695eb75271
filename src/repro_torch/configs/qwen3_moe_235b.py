"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

235 B parameters (470 GB in bf16): no single card holds it, so the
launcher refuses it there (``launch.serve.check_weights_fit``). Its G = 16
query heads per KV head take the decode kernels' 16-row bodies; the card
serves it at full width with its depth cut. It is registered for the
control plane and the CPU tests.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,           # per-expert hidden size
    vocab=151_936,
    head_dim=64,
    n_experts=128,
    top_k=8,
    n_shared_experts=0,
    subquadratic=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
