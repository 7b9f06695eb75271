"""llama-3.2-vision-90b [vlm] — cross-attn image layers, backbone only.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a stub: the model takes precomputed patch embeddings
(B, n_image_tokens, d_model). Every 10th decoder layer is a cross-attention
layer over the patch embeddings (10 cross layers for 100 layers).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab=128_256,
    head_dim=128,
    cross_attn_every=10,
    n_image_tokens=1601,     # one 560x560 tile + CLS, llama3.2-vision default
    subquadratic=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
