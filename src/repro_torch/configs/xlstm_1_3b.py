"""xlstm-1.3b [ssm]: 48L, d_model=2048, 4H, d_ff=0 (no separate FFN; blocks
carry internal up-projections), vocab=50304 -- sLSTM + mLSTM blocks (7:1).
[arXiv:2405.04517; unverified]
(Same values as ``repro.configs.xlstm_1_3b``.)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm_1_3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    xlstm_proj_factor=2.0,
)
