"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

d_ff=0 per assignment: the up/down projections live inside the xLSTM blocks
(mLSTM proj factor 2, sLSTM gated FFN 4/3). One sLSTM block every
``slstm_every`` layers, the rest chunkwise-parallel mLSTM.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    head_dim=512,
    slstm_every=4,
    ssm_chunk=256,
    subquadratic=True,
    source="arXiv:2405.04517",
)
