"""whisper-base [audio] — enc-dec transformer backbone, conv frontend stub.
[arXiv:2212.04356; unverified]

The model takes precomputed frame embeddings (B, S, d_model); the strided-
conv mel frontend is a stub, as in ``repro``. 6 encoder + 6 decoder layers
(decoder layers carry self- and cross-attention).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,              # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    head_dim=64,
    subquadratic=False,
    source="arXiv:2212.04356",
)
